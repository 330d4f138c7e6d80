"""deblock_ms (layer: filters, `filters/deblocking.py`): the chain's
`DeblockingFilter.step` alone, captured as a CUDA graph and replayed over
the cell's own frames (frame t mod T at step t), ms a call.  Moves
`frames_per_s.4k_chain`."""

import torch


def read(run):
    prog = run.program
    if run.device.type != "cuda" or "frames" not in prog:
        return None
    from livevisionkit_tpu_torch.data.frame import Frame
    from livevisionkit_tpu_torch.filters.deblocking import DeblockingFilter

    from harness.stage import graph_ms

    filt = prog["filter"]
    deblock = next((f for f in getattr(filt, "filters", (filt,)) if isinstance(f, DeblockingFilter)), None)
    if deblock is None:
        return None
    clip, fmt = prog["frames"], prog["format"]
    n = clip.shape[0]
    live = torch.ones((), dtype=torch.bool, device=run.device)

    def body(state, t):
        i = torch.remainder(t.to(torch.int64), n).reshape(1)
        frame = Frame(pixels=clip.index_select(0, i)[0], timestamp=t, valid=live, format=fmt)
        return deblock.step(state, frame)

    return graph_ms(body, None, run.device)
