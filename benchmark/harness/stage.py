"""One stage of the program timed alone as a CUDA graph, from outside
(frozen from `tools/profile_stages_torch.graph_time`): `body(state, t) ->
(state, out)` is compiled by the port's `jit_step` with `t` a 0-d float32
step counter carried on the card, captured once and replayed; the time is
CUDA events around `n` back-to-back replays, the least of `reps` runs."""

from __future__ import annotations

import gc


def graph_ms(body, state, device, n: int = 60, reps: int = 3) -> float:
    import torch

    from livevisionkit_tpu_torch.utils.compiled import jit_step

    def step(carry):
        st, t = carry
        st, out = body(st, t)
        return (st, t + 1.0), out

    carry = (state, torch.zeros((), dtype=torch.float32, device=device))
    times = []
    with torch.cuda.device(device):
        compiled = jit_step(step)
        carry, _ = compiled(carry)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for _ in range(reps):
            torch.cuda.synchronize(device)
            start.record()
            for _ in range(n):
                carry, _ = compiled(carry)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / n)
        del compiled, carry
        gc.collect()
        torch.cuda.empty_cache()
    return min(times)
