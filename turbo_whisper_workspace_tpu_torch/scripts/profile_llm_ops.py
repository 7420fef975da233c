"""The LLM-ops profiler: a decode step's projection costs per weight format.

Port of scripts/profile_llm_ops.py. At batch 1 a decode step streams
every projection weight once. This times S steps of the whole per-layer
projection stack (q, k, v, out, gate, up, down at m = 1, for each of
the model's L layers) and of the lm_head, in each weight format, and
prints the ms per step of each:

  bf16   dense bf16 weights (torch.matmul), the 2-bytes-a-weight anchor
  int8   int8 weights through ops.quant.int8_matmul
  xla8   int8 weights dequantized to bf16 before the product
         (ops.quant._int8_matmul_xla, the JAX package's XLA dequant matmul)
  s8     int8 weights × int8 activations quantized per row: s8_matmul
  int4   grouped int4 weights through ops.quant.int4_matmul
  xla4   the int4 dequant twin, ops.quant._int4_matmul_xla
  s8g4   grouped int4 weights × int8 activations quantized per group:
         s8g4_matmul
  head   the int8 lm_head three ways: int8_matmul, s8_matmul, dequant

    python -m turbo_whisper_workspace_tpu_torch.scripts.profile_llm_ops \\
        [--model llama-3.2-3b] [--steps 32] [--iters 3] \\
        [--variants bf16,int8,s8,int4,s8g4,head] [--device cuda]

It runs on the card unless `--device cpu` is given; on the CPU each
kernel's plain version stands in and the times are the CPU's. Weights
are random, drawn on the device from a seeded torch.Generator (integer
draws, as the JAX script makes them). PyTorch runs eagerly and hoists
nothing out of the loop, so the JAX script's carry-perturbed inputs are
not needed; a step is timed with the host clock around work that ends
in a device synchronize, launch overhead included. The keys of the
printed JSON are the JAX script's, so that the two outputs line up:
"pallas (shipping)" names the kernel that the port's CUDA kernel
replaces and "MXU" the s8×s8 route.

Two kernels live here, each with a wrapper and a plain PyTorch version
beside it: `s8_matmul` (csrc/s8_matmul.cu: a split-K GEMV at M ≤ 16,
mma.sync tiles above; its plan is `s8_plan`) and `s8g4_matmul`
(csrc/s8g4_matmul.cu: the same GEMV on the nibble planes, K split by
group pairs and the f32 terms folded in group order, at M ≤ 16; the
first design's mma tiles above; its plan is `s8g4_plan`). For CUDA
tensors a wrapper checks them, allocates the output, launches its kernel
on the current stream and counts the launch in `launch_counts`; for CPU
tensors it runs the plain version; anything else raises.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..models import llama as lm
from ..ops import build
from ..ops import quant
from ..ops.attention import _div
from ..ops.build import _check_cuda, _stream, count_launch
from ..ops.quant import quant_act_grouped
from ..pipeline.transcriber import resolve_device

GROUP = 128
BLOCK_M = 16          # the kernels' rows of M per block (the int8 mma's M)
S8_GEMV_MAX_M = 16    # the GEMV rows of s8_matmul and s8g4_matmul: two n8 tiles of x
S8_GEMV_STEP = 32     # K (s8g4: packed) rows a GEMV step (the int8 mma's depth)
# s8g4_matmul's GEMV blocks the H100 holds at once in clusters of 4 and 8
# (cudaOccupancyMaxActiveClusters: 62 and 30, two blocks an SM), and the
# shared memory a block may use with two an SM (228 KB less the 1 KB
# reserved a block, halved)
S8G4_CLUSTER_BLOCKS = {4: 248, 8: 240}
S8G4_GEMV_SMEM = (228 * 1024 - 2 * 1024) // 2
MAX_SMEM = 227 * 1024  # shared memory a block may use on Hopper

# kernel name → launches since the last reset_launch_counts()
launch_counts = {name: 0 for name in ("s8_matmul", "s8g4_matmul")}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def quant_act(x: torch.Tensor):
    """(M, K) float → (xq int8 (M, K), xs f32 (M, 1)): symmetric int8
    per row, round half to even."""
    xf = x.float()
    xs = _div(xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12), 127.0)
    xq = torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8)
    return xq, xs


# ---------------------------------------------------------------------------
# s8_matmul: int8 activations (per-row scale) × int8 weights (per-column scale)


def s8_matmul_reference(xq: torch.Tensor, xs: torch.Tensor, w_q: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's math (_s8_kernel): the exact integer product
    xq @ w_q (float64 holds every sum exactly), rounded once to f32, × xs
    (M, 1) and then × scale (N,) in f32, bf16 out."""
    acc = (xq.double() @ w_q.double()).float()
    return (acc * xs * scale).to(torch.bfloat16)


def s8_plan(m: int, k: int, n: int) -> tuple[str, int]:
    """s8_matmul's regime and K split, mirroring csrc/s8_matmul.cu:
    make_plan: ("gemv", split) for M ≤ S8_GEMV_MAX_M (the split-K GEMV
    of csrc/gemv_mma.cuh over K steps of S8_GEMV_STEP rows, split as
    ops.quant.gemv_split says), ("mma", 1) above (16-row mma tiles, K
    split over a block's warps only)."""
    if m <= S8_GEMV_MAX_M:
        return "gemv", quant.gemv_split(-(-k // S8_GEMV_STEP), n)
    return "mma", 1


def s8_matmul(xq: torch.Tensor, xs: torch.Tensor, w_q: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """xq (M, K) int8 with xs (M, 1) f32 @ w_q (K, N) int8 with scale
    (N,) f32 → (M, N) bf16.

    CUDA: csrc/s8_matmul.cu, the regime `s8_plan` names; K and N
    multiples of 4; ragged M, N and K are masked in the kernel (no padded
    copy of W). CPU: the plain version."""
    if xq.device.type == "cpu":
        return s8_matmul_reference(xq, xs, w_q, scale)
    _check_cuda("s8_matmul", {"xq": xq, "xs": xs, "w_q": w_q, "scale": scale},
                {"xq": torch.int8, "xs": torch.float32, "w_q": torch.int8,
                 "scale": torch.float32}, align=4)
    m, k = xq.shape
    n = w_q.shape[-1]
    if w_q.shape != (k, n) or xs.shape != (m, 1) or scale.shape != (n,):
        raise ValueError(f"s8_matmul: expected xq (M, K), xs (M, 1), w_q (K, N), "
                         f"scale (N,); got {xq.shape}, {xs.shape}, {w_q.shape}, "
                         f"{scale.shape}")
    if m < 1 or k < 4 or k % 4 or n < 4 or n % 4 or -(-m // BLOCK_M) > 65535:
        raise ValueError(f"s8_matmul: M={m}, K={k} and N={n} (multiples of 4) "
                         f"out of range")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=xq.device)
    build.launch("s8_matmul", xq.data_ptr(), xs.data_ptr(), w_q.data_ptr(),
                 scale.data_ptr(), out.data_ptr(), m, k, n, _stream(xq.device))
    count_launch(launch_counts, "s8_matmul")
    return out


# ---------------------------------------------------------------------------
# s8g4_matmul: int8 activations (per-group scales) × grouped int4 weights


def s8g4_matmul_reference(xq: torch.Tensor, xs: torch.Tensor, w_q4: torch.Tensor,
                          scale4: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's math (_s8g4_kernel), which is int4_matmul_s8's
    down to the order of the group sums (exact s32 dots per group, then
    acc + dot · (xs · ws) in f32, groups in order, bf16 out): this calls
    ops.quant.int4_matmul_s8_reference."""
    return quant.int4_matmul_s8_reference(xq, xs, w_q4, scale4)


def s8g4_gemv_smem(m: int, n_groups: int, group: int, split: int) -> int:
    """Bytes of shared memory s8g4_matmul's GEMV block takes
    (csrc/s8g4_matmul.cu:gemv_layout): the s32 dots of its rank's steps
    (G/S8_GEMV_STEP a group pair, the most pairs a rank of `split`
    holds) in two nibble planes of m rows × quant.GEMV_COLS; the ws tile
    of the rank's groups; the terms of the GEMV_COLS/split columns the
    rank folds, m rows, every group; the xs tile."""
    pairs = -(-(n_groups // 2) // split)
    spp = group // S8_GEMV_STEP
    return 4 * (pairs * spp * 2 * m * quant.GEMV_COLS + 2 * pairs * quant.GEMV_COLS
                + n_groups * m * (quant.GEMV_COLS // split) + 2 * pairs * m)


def s8g4_plan(m: int, k: int, n: int, group: int = GROUP) -> tuple[str, int]:
    """s8g4_matmul's regime and K split, mirroring
    csrc/s8g4_matmul.cu:make_plan. ("gemv", split) at M ≤
    S8_GEMV_MAX_M: the split (cluster size, a power of two; rank r
    takes group pairs [r·P/split, (r+1)·P/split) of the P = n_groups/2)
    is ops.quant.gemv_split over K steps of S8_GEMV_STEP packed rows,
    halved while it exceeds P or the grid exceeds the blocks the card
    holds at once in clusters of 4 or 8 (S8G4_CLUSTER_BLOCKS), then
    doubled (to at most 8 and P, within that bound) while the block's
    shared memory exceeds S8G4_GEMV_SMEM (two blocks an SM). ("mma", 1)
    above, or where no such split exists."""
    n_groups = k // group
    half = n_groups // 2
    tiles = -(-n // quant.GEMV_COLS)

    def fits(split):
        return tiles * split <= S8G4_CLUSTER_BLOCKS.get(split, tiles * split)

    if m > S8_GEMV_MAX_M:
        return "mma", 1
    split = quant.gemv_split(k // 2 // S8_GEMV_STEP, n)
    while split > half or not fits(split):
        split //= 2
    while (s8g4_gemv_smem(m, n_groups, group, split) > S8G4_GEMV_SMEM
           and 2 * split <= min(quant.GEMV_MAX_SPLIT, half) and fits(2 * split)):
        split *= 2
    if s8g4_gemv_smem(m, n_groups, group, split) > S8G4_GEMV_SMEM:
        return "mma", 1
    return "gemv", split


def s8g4_matmul(xq: torch.Tensor, xs: torch.Tensor, w_q4: torch.Tensor,
                scale4: torch.Tensor) -> torch.Tensor:
    """W4A8 on the tensor cores: xq (M, K) int8 with xs (M, K/G) f32
    against w_q4 (K/2, N) packed and scale4 (K/G, N) f32 → (M, N) bf16.

    CUDA: csrc/s8g4_matmul.cu, the regime `s8g4_plan` names; G a
    multiple of 32; ragged M and N are masked in the kernel. CPU: the
    plain version."""
    if xq.device.type == "cpu":
        return s8g4_matmul_reference(xq, xs, w_q4, scale4)
    _check_cuda("s8g4_matmul", {"xq": xq, "xs": xs, "w_q4": w_q4, "scale4": scale4},
                {"xq": torch.int8, "xs": torch.float32, "w_q4": torch.int8,
                 "scale4": torch.float32}, align=4)
    m, k = xq.shape
    n = quant._check_int4("s8g4_matmul", k, w_q4, scale4)
    n_groups = scale4.shape[0]
    if xs.shape != (m, n_groups):
        raise ValueError(f"s8g4_matmul: xs must be (M, K/G) = {(m, n_groups)}, "
                         f"got {xs.shape}")
    # the mma tiles keep the high groups' terms and one chunk of 8 low
    # groups' terms of their (≤ 16, 32) tile in shared memory; the GEMV's
    # plan fits its own
    smem = (n_groups // 2 + 8) * min(m, BLOCK_M) * 32 * 4
    if (k // n_groups) % 32 or not 1 <= m <= 65535 * BLOCK_M or (
            smem > MAX_SMEM and s8g4_plan(m, k, n, k // n_groups)[0] == "mma"):
        raise ValueError(f"s8g4_matmul: group {k // n_groups} (a multiple of 32), "
                         f"M={m} or {n_groups} groups out of range")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=xq.device)
    build.launch("s8g4_matmul", xq.data_ptr(), xs.data_ptr(), w_q4.data_ptr(),
                 scale4.data_ptr(), out.data_ptr(), m, k, n, n_groups, _stream(xq.device))
    count_launch(launch_counts, "s8g4_matmul")
    return out


# ---------------------------------------------------------------------------
# The profiler


def layer_shapes(dims):
    d, kv, ff = dims.d_model, dims.n_kv_head * dims.head_dim, dims.d_ff
    return [("q", d, d), ("k", d, kv), ("v", d, kv), ("out", d, d),
            ("gate", d, ff), ("up", d, ff), ("down", ff, d)]


def timeit(name: str, fn, iters: int, steps: int, results: dict,
           device: torch.device, bytes_per_step: float | None = None) -> None:
    """ms per step of `fn`, one call of which runs `steps` decode steps:
    one first call (the kernels' build included), then the mean of
    `iters` calls, host clock around work that ends in a synchronize."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    fn()
    sync()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    dt = (time.perf_counter() - t0) / iters / steps * 1000.0
    gbs = f"  {bytes_per_step / dt / 1e6:7.0f} GB/s" if bytes_per_step else ""
    print(f"{name:40s} {dt:9.3f} ms/step{gbs}   (first call {first_s:.1f}s)",
          flush=True)
    results[name] = round(dt, 4)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="llama-3.2-3b")
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--variants", default="bf16,int8,s8,int4,s8g4,head")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    dims = lm.LLAMA_CONFIGS[args.model]
    S, L = args.steps, dims.n_layer
    d, ff = dims.d_model, dims.d_ff
    variants = args.variants.split(",")
    gen = torch.Generator(device).manual_seed(0)
    results = {}
    shapes = layer_shapes(dims)
    layer_elems = sum(k * n for _, k, n in shapes)
    head_elems = d * dims.n_vocab
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"{args.model} on {where}: per-layer weight elems {layer_elems / 1e6:.1f}M, "
          f"L={L}, head {head_elems / 1e6:.1f}M elems", flush=True)

    def randint(low, high, shape):
        return torch.randint(low, high, shape, generator=gen, device=device,
                             dtype=torch.int8)

    xd = torch.randn((1, d), generator=gen, device=device).to(torch.bfloat16)
    xf = torch.randn((1, ff), generator=gen, device=device).to(torch.bfloat16)

    def run(step):
        """S decode steps of `step`, which runs every layer's projections
        through project(x, w_l, s_l) for stacked weights and scales."""
        def fn():
            for _ in range(S):
                step()
        return fn

    def layers(project, ws, ss, rows_ff):
        def step():
            for li in range(L):
                for w, s in zip(ws, ss):
                    project(w.shape[1] == rows_ff, w[li], s[li])
        return step

    if "bf16" in variants:
        ws = [torch.randn((L, k, n), generator=gen, device=device,
                          dtype=torch.bfloat16).mul_(0.02) for _, k, n in shapes]

        def step_bf16():
            for li in range(L):
                for w in ws:
                    (xf if w.shape[1] == ff else xd) @ w[li]

        timeit("layers bf16 dense", run(step_bf16), args.iters, S, results, device,
               bytes_per_step=2 * L * layer_elems)
        del ws

    if any(v in variants for v in ("int8", "s8", "xla8")):
        wq = [randint(-127, 128, (L, k, n)) for _, k, n in shapes]
        sc = [torch.full((L, n), 0.01, device=device) for _, k, n in shapes]

        if "int8" in variants:
            step = layers(lambda is_ff, w, s: quant.int8_matmul(xf if is_ff else xd, w, s),
                          wq, sc, ff)
            timeit("layers int8 pallas (shipping)", run(step), args.iters, S, results,
                   device, bytes_per_step=L * layer_elems)

        if "xla8" in variants:
            step = layers(lambda is_ff, w, s: quant._int8_matmul_xla(xf if is_ff else xd, w, s),
                          wq, sc, ff)
            timeit("layers int8 XLA dequant-einsum", run(step), args.iters, S, results,
                   device, bytes_per_step=L * layer_elems)

        if "s8" in variants:
            def step_s8():
                xdq, xds = quant_act(xd)
                xfq, xfs = quant_act(xf)
                layers(lambda is_ff, w, s: s8_matmul(xfq, xfs, w, s) if is_ff
                       else s8_matmul(xdq, xds, w, s), wq, sc, ff)()

            timeit("layers s8xs8 MXU (prototype)", run(step_s8), args.iters, S, results,
                   device, bytes_per_step=L * layer_elems)
        del wq, sc

    if any(v in variants for v in ("int4", "s8g4", "xla4")):
        wq4 = [randint(-128, 128, (L, k // 2, n)) for _, k, n in shapes]
        sc4 = [torch.full((L, k // GROUP, n), 0.01, device=device) for _, k, n in shapes]

        if "int4" in variants:
            step = layers(lambda is_ff, w, s: quant.int4_matmul(xf if is_ff else xd, w, s),
                          wq4, sc4, ff // 2)
            timeit("layers int4 pallas (shipping)", run(step), args.iters, S, results,
                   device, bytes_per_step=L * layer_elems // 2)

        if "xla4" in variants:
            step = layers(lambda is_ff, w, s: quant._int4_matmul_xla(xf if is_ff else xd, w, s),
                          wq4, sc4, ff // 2)
            timeit("layers int4 XLA twin", run(step), args.iters, S, results, device,
                   bytes_per_step=L * layer_elems // 2)

        if "s8g4" in variants:
            def step_s8g4():
                xdq, xds = quant_act_grouped(xd, d // GROUP)
                xfq, xfs = quant_act_grouped(xf, ff // GROUP)
                layers(lambda is_ff, w, s: s8g4_matmul(xfq, xfs, w, s) if is_ff
                       else s8g4_matmul(xdq, xds, w, s), wq4, sc4, ff // 2)()

            timeit("layers s8xs8 grouped-int4 (proto)", run(step_s8g4), args.iters, S,
                   results, device, bytes_per_step=L * layer_elems // 2)
        del wq4, sc4

    if "head" in variants:
        hq = randint(-127, 128, (d, dims.n_vocab))
        hs = torch.full((dims.n_vocab,), 0.01, device=device)

        def head_s8():
            xq, xs = quant_act(xd)
            s8_matmul(xq, xs, hq, hs)

        for name, step in (
                ("lm_head int8 pallas (shipping)", lambda: quant.int8_matmul(xd, hq, hs)),
                ("lm_head s8xs8 MXU (prototype)", head_s8),
                ("lm_head int8 XLA dequant-einsum",
                 lambda: quant._int8_matmul_xla(xd, hq, hs))):
            timeit(name, run(step), args.iters, S, results, device,
                   bytes_per_step=head_elems)
        del hq, hs

    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
