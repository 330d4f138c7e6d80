"""tracker_ms (layer: tracker, `vision/frame_tracker.py`,
`vision/ransac.py`): `frame_tracker.track` alone, captured as a CUDA graph
and replayed over the cell's own frames (the luma of frame t mod T at
step t), ms a call.  Moves `frames_per_s`."""

import torch


def read(run):
    prog = run.program
    if run.device.type != "cuda" or "frames" not in prog:
        return None
    from livevisionkit_tpu_torch.filters.stabilization import StabilizationFilter
    from livevisionkit_tpu_torch.vision import frame_tracker

    from harness.stage import graph_ms

    filt = prog["filter"]
    stab = next(f for f in getattr(filt, "filters", (filt,)) if isinstance(f, StabilizationFilter))
    settings = stab.settings.tracker
    clip = prog["frames"]
    n = clip.shape[0]

    def body(state, t):
        i = torch.remainder(t.to(torch.int64), n).reshape(1)
        return frame_tracker.track(state, clip.index_select(0, i)[0, 0], settings)

    return graph_ms(body, frame_tracker.init(settings, device=run.device), run.device)
