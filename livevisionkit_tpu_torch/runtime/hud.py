"""Frame-time HUD: the reference's test-mode latency readout (counterpart
of livevisionkit_tpu/runtime/hud.py, kept as the port's own copy).

Reference parity: the OBS filters draw the measured per-frame filter time
onto the output in test mode, coloured by a per-filter budget — green under
budget, red over (VSFilter.cpp:71,368-383, 6 ms budget; ADBFilter.cpp:38,152,
3 ms).  The reference renders through the host graphics API, outside the
filter kernel; here the overlay stamps the drained host frame (numpy), so
the device step is untouched and the HUD shows the true host-measured
frame time, like the reference's Stopwatch-driven readout.
"""

from __future__ import annotations

import numpy as np

# 3x5 bitmap glyphs for "0123456789.ms" (1 = lit).
_GLYPHS = {
    "0": "111101101101111", "1": "010110010010111", "2": "111001111100111",
    "3": "111001111001111", "4": "101101111001001", "5": "111100111001111",
    "6": "111100111101111", "7": "111001010010010", "8": "111101111101111",
    "9": "111101111001111", ".": "000000000000010", "m": "000000111111101",
    "s": "000000011010110", " ": "000000000000000",
}

GREEN = (0.1, 0.9, 0.1)
RED = (0.95, 0.15, 0.1)


def draw_frame_time_hud(
    planar: np.ndarray,  # (C, H, W) float frame, modified in place
    frame_ms: float,
    budget_ms: float,
    scale: int = 3,
    origin: tuple[int, int] = (6, 6),
) -> np.ndarray:
    """Stamp "<ms> ms" plus a budget bar; green within budget, red over
    (reference VSFilter.cpp:368-383 semantics)."""
    c, h, w = planar.shape
    colour = GREEN if frame_ms <= budget_ms else RED
    col = np.asarray(colour[:c], np.float32).reshape(-1, 1, 1)

    text = f"{frame_ms:.1f}ms"
    oy, ox = origin
    x = ox
    for ch in text:
        g = _GLYPHS.get(ch, _GLYPHS[" "])
        bits = np.asarray([b == "1" for b in g], bool).reshape(5, 3)
        bits = np.kron(bits, np.ones((scale, scale), bool))
        gh, gw = bits.shape
        if oy + gh >= h or x + gw >= w:
            break
        region = planar[:, oy : oy + gh, x : x + gw]
        region[:, bits] = np.broadcast_to(col, (c, gh, gw))[:, bits]
        x += gw + scale

    # Budget bar under the text: filled fraction = time/budget (clipped 2x).
    bar_y = oy + 5 * scale + scale
    bar_h = max(scale, 2)
    bar_w = 40 * scale
    if bar_y + bar_h < h and ox + bar_w < w:
        frac = min(frame_ms / max(budget_ms, 1e-6), 2.0) / 2.0
        fill = max(1, int(bar_w * frac))
        planar[:, bar_y : bar_y + bar_h, ox : ox + bar_w] *= 0.25
        planar[:, bar_y : bar_y + bar_h, ox : ox + fill] = np.broadcast_to(
            col, (c, bar_h, fill)
        )
        # Budget tick at the halfway mark (= exactly on budget).
        tick = ox + bar_w // 2
        planar[:, bar_y : bar_y + bar_h, tick : tick + max(scale // 2, 1)] = 1.0
    return planar
