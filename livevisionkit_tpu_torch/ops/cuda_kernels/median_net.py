"""The median-selection networks of the deblocker's kernels (K8,
csrc/median_net.cuh, generated from this module).

A network is the JAX package's (livevisionkit_tpu/ops/resample.
_median_network): Batcher's merge-exchange sorting network of n inputs
(Knuth vol. 3, algorithm 5.2.2M; correct by the 0-1 principle), pruned
backward to the compare-exchanges that reach output n // 2.  Each kept
exchange also says which of its two results is read later: the minimum
(written to its first wire), the maximum (to its second) or both, so a
half-read exchange costs one `fminf` or `fmaxf` in place of two.  For the
5 x 5 median that is 113 exchanges and 202 min/max operations.

Every result of a min/max network is one of its inputs, so the kernels'
median is an input bit for bit, as `torch.median`'s is.  Regenerate the
header after a change here:

    python -m livevisionkit_tpu_torch.ops.cuda_kernels.median_net \\
        > livevisionkit_tpu_torch/csrc/median_net.cuh
"""

from __future__ import annotations

import functools

KSIZES = (3, 5, 7)  # the window sides the kernels are built for


@functools.cache
def median_network(n: int) -> tuple[tuple[int, int, bool, bool], ...]:
    """(a, b, lo, hi) of each compare-exchange selecting the median of n
    (odd) values on wires 0..n-1, in order: the minimum of wires a < b
    goes to a where `lo`, the maximum to b where `hi`; the median ends on
    wire n // 2."""
    if n % 2 != 1:
        raise ValueError(f"a median network needs an odd count, got {n}")
    ces = []
    t = 1
    while t < n:
        t *= 2
    p = t // 2
    while p >= 1:
        q, r, d = t // 2, 0, p
        while d > 0:
            for i in range(n - d):
                if (i & p) == r:
                    ces.append((i, i + d))
            d, q, r = q - p, q // 2, p
        p //= 2
    live, kept = {n // 2}, []
    for a, b in reversed(ces):
        lo, hi = a in live, b in live
        if lo or hi:
            kept.append((a, b, lo, hi))
            live |= {a, b}
    return tuple(reversed(kept))


def header() -> str:
    """The text of csrc/median_net.cuh: for each window side k of KSIZES,
    `Net<k * k>::run(v)` leaves the median of the k * k values of `v` in
    `v[k * k / 2]`, with every index a constant, so `v` stays in
    registers."""
    out = [
        "// Median-selection networks of the deblocker's kernels (csrc/deblock.cu).",
        "// Generated by livevisionkit_tpu_torch/ops/cuda_kernels/median_net.py: edit",
        "// that module and regenerate, not this file.",
        "#pragma once",
        "",
        "namespace lvk_median {",
        "",
        "// A compare-exchange of wires a < b: both results, the minimum alone, the",
        "// maximum alone.",
        "#define LVK_X(a, b) { const float lo = fminf(v[a], v[b]); v[b] = fmaxf(v[a], v[b]); v[a] = lo; }",
        "#define LVK_LO(a, b) v[a] = fminf(v[a], v[b]);",
        "#define LVK_HI(a, b) v[b] = fmaxf(v[a], v[b]);",
        "",
        "template <int N>",
        "struct Net;",
    ]
    ops = {(True, True): "LVK_X", (True, False): "LVK_LO", (False, True): "LVK_HI"}
    for k in KSIZES:
        n = k * k
        net = median_network(n)
        calls = [f"{ops[lo, hi]}({a}, {b});" for a, b, lo, hi in net]
        out += ["", f"// {k} x {k}: {len(net)} exchanges, "
                    f"{sum(lo + hi for _, _, lo, hi in net)} min/max operations.",
                "template <>", f"struct Net<{n}> {{",
                f"  __device__ __forceinline__ static void run(float (&v)[{n}]) {{"]
        out += ["    " + " ".join(calls[i:i + 6]) for i in range(0, len(calls), 6)]
        out += ["  }", "};"]
    out += ["", "#undef LVK_X", "#undef LVK_LO", "#undef LVK_HI", "", "}  // namespace lvk_median", ""]
    return "\n".join(out)


if __name__ == "__main__":
    print(header(), end="")
