"""Port quantization (turbo_whisper_workspace_tpu_torch/ops/quant.py)
against the JAX package.

The quantizers must be bit-equal to the JAX package's numpy versions;
each kernel's plain version is held to the JAX Pallas kernel in
interpret mode and its XLA twin on the same numpy inputs (relative L2
1e-5 where both sides keep f32 outputs, at most 1e-2 where the output is
bf16).
The CUDA kernels themselves need a card: the `cuda`-marked test holds
them to the plain versions there.
"""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turbo_whisper_workspace_tpu.ops import quant as jq
from turbo_whisper_workspace_tpu_torch.ops import quant as tq


def rel_l2(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("shape", [(128, 256), (3, 64, 128)])
def test_quantize_int8_bit_equal_to_jax(shape):
    w = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    w[..., 5] = 0.0                       # an all-zero column: the scale clamps at 1e-12
    ref = jq.quantize_int8(w)
    got = tq.quantize_int8(torch.from_numpy(w))
    assert got["w_q"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["w_q"].numpy(), np.asarray(ref["w_q"]))
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(ref["scale"]))


@pytest.mark.parametrize("shape,group", [((256, 192), 128), ((256, 200), 16),
                                         ((2, 64, 96), 8)])
def test_quantize_int4_bit_equal_to_jax(shape, group):
    w = (np.random.default_rng(1).standard_normal(shape) * 3).astype(np.float32)
    ref = jq.quantize_int4(w, group=group)
    got = tq.quantize_int4(torch.from_numpy(w), group=group)
    k = shape[-2]
    assert got["w_q4"].shape == shape[:-2] + (k // 2, shape[-1])
    assert got["scale4"].shape == shape[:-2] + (k // group, shape[-1])
    np.testing.assert_array_equal(got["w_q4"].numpy(), np.asarray(ref["w_q4"]))
    np.testing.assert_array_equal(got["scale4"].numpy(), np.asarray(ref["scale4"]))
    with pytest.raises(ValueError):
        tq.quantize_int4(torch.zeros(24, 8), group=16)


def _tiny_tree(seed=2):
    """A test-tiny-shaped JAX-layout tree (stacked blocks) of numpy f32."""
    rng = np.random.default_rng(seed)
    l, d, kv, ff, v = 2, 64, 32, 128, 512
    shapes = {"q": (d, d), "k": (d, kv), "v": (d, kv), "out": (d, d),
              "gate": (d, ff), "up": (d, ff), "down": (ff, d)}
    blocks = {n: {"w": rng.standard_normal((l,) + s).astype(np.float32)}
              for n, s in shapes.items()}
    blocks["attn_norm"] = {"scale": np.ones((l, d), np.float32)}
    blocks["fc1"] = {"w": rng.standard_normal((l, 40, 24)).astype(np.float32),
                     "b": rng.standard_normal((l, 24)).astype(np.float32)}
    return {"token_emb": rng.standard_normal((v, d)).astype(np.float32),
            "blocks": blocks, "norm": {"scale": np.ones(d, np.float32)},
            "lm_head": {"w": rng.standard_normal((d, v)).astype(np.float32)}}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_tree_bit_equal_to_jax(bits):
    tree = _tiny_tree()
    ref = dict(_flat(jq.quantize_tree(tree, bits=bits, group=16)))
    got = dict(_flat(tq.quantize_tree(_flat_to_torch(tree), bits=bits, group=16)))
    assert sorted(got) == sorted(ref)
    for key, val in ref.items():
        np.testing.assert_array_equal(_np(got[key]), np.asarray(val), err_msg=key)
    if bits == 4:
        # int4 body; fc1 (K = 40) falls back to int8, since no group ≥ 8
        # has 2·group dividing 40; int8 head
        assert "/blocks/q/w_q4" in got and "/blocks/fc1/w_q" in got
        assert "/lm_head/w_q" in got and "/blocks/fc1/b" in got


def _flat_to_torch(tree):
    if isinstance(tree, dict):
        return {k: _flat_to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(tree)


def test_quantize_tree_walks_layer_lists():
    """The port keeps one dict per layer; each layer quantizes as the
    same slice of the stacked tree."""
    tree = _tiny_tree(3)
    stacked = tq.quantize_tree(_flat_to_torch(tree), bits=4)
    layers = [{n: {k: torch.from_numpy(v[i]) for k, v in p.items()}
               for n, p in tree["blocks"].items()} for i in range(2)]
    listed = tq.quantize_tree({"blocks": layers}, bits=4)["blocks"]
    for i, layer in enumerate(listed):
        for name, proj in layer.items():
            for key, val in proj.items():
                torch.testing.assert_close(val, stacked["blocks"][name][key][i],
                                           rtol=0, atol=0)


def test_quant_act_grouped_bit_equal_to_jax():
    x = (np.random.default_rng(4).standard_normal((5, 256)) * 2).astype(np.float32)
    x[1, :64] = 0.0                        # an all-zero group
    xq_j, xs_j = jq.quant_act_grouped(jnp.asarray(x), 4)
    xq_t, xs_t = tq.quant_act_grouped(torch.from_numpy(x), 4)
    assert xq_t.dtype == torch.int8 and xs_t.shape == (5, 4)
    np.testing.assert_array_equal(xq_t.numpy(), np.asarray(xq_j))
    np.testing.assert_array_equal(xs_t.numpy(), np.asarray(xs_j))


def _inputs(m, k, n, bits, group=32, seed=5, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    q = jq.quantize_int8(w) if bits == 8 else jq.quantize_int4(w, group=group)
    q = {key: np.array(val) for key, val in q.items()}       # writable copies
    if dtype == "bfloat16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    return x, q


def _x_pair(x, dtype):
    """The same x for both packages, f32 or bf16."""
    if dtype == "bfloat16":
        return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("n", [256, 200])                 # 200: ragged against block_n
def test_int8_reference_matches_jax(dtype, tol, n):
    x, q = _inputs(12, 128, n, 8, dtype=dtype)
    xj, xt = _x_pair(x, dtype)
    wq, s = torch.from_numpy(q["w_q"]), torch.from_numpy(q["scale"])
    got = tq.int8_matmul_reference(xt, wq, s)
    assert got.dtype == xt.dtype and got.shape == (12, n)
    pallas = jq.int8_matmul(xj, q["w_q"], q["scale"], block_n=128, interpret=True)
    assert rel_l2(_np(got), np.asarray(pallas, np.float32)) <= tol
    # the m ≤ 8 route's dequant matmul against the JAX package's XLA twin
    # (both round the product to bf16)
    got_xla = tq._int8_matmul_xla(xt[:4], wq, s)
    ref_xla = jq._int8_matmul_xla(xj[:4], q["w_q"], q["scale"])
    assert rel_l2(_np(got_xla), np.asarray(ref_xla, np.float32)) <= 1e-2
    assert rel_l2(_np(got_xla), _np(got[:4])) <= 1e-2


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("n,group", [(256, 32), (200, 16)])
def test_int4_reference_matches_jax(dtype, tol, n, group):
    x, q = _inputs(12, 256, n, 4, group=group, dtype=dtype)
    xj, xt = _x_pair(x, dtype)
    wq, s = torch.from_numpy(q["w_q4"]), torch.from_numpy(q["scale4"])
    got = tq.int4_matmul_reference(xt, wq, s)
    assert got.dtype == xt.dtype and got.shape == (12, n)
    pallas = jq.int4_matmul(xj, q["w_q4"], q["scale4"], block_n=128, interpret=True)
    assert rel_l2(_np(got), np.asarray(pallas, np.float32)) <= tol
    # the XLA twin rounds its output to bf16 whatever x's dtype
    got_xla = tq._int4_matmul_xla(xt, wq, s)
    ref_xla = jq._int4_matmul_xla(xj, q["w_q4"], q["scale4"])
    assert got_xla.dtype == torch.bfloat16
    assert rel_l2(_np(got_xla), np.asarray(ref_xla, np.float32)) <= 1e-2
    # the halves dequantize bit-equal
    for a, b in zip(tq._dequant4_halves(wq, s, 256),
                    jq._dequant4_halves(jnp.asarray(q["w_q4"]), jnp.asarray(q["scale4"]), 256)):
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))


# the group size too: 8 groups of 32, 16 of 16, and 2 groups of 128 (one
# group pair, the kernel's smallest) at the ragged N = 1000; M = 3 and 9
# take the kernel's row pairs with an odd row and a second chunk of 8
@pytest.mark.parametrize("m,n,group", [(1, 256, 32), (8, 200, 32), (13, 256, 32),
                                       (1, 1000, 128), (3, 1000, 128), (9, 256, 16)])
def test_int4_s8_reference_matches_jax(m, n, group):
    n_groups = 256 // group
    x, q = _inputs(m, 256, n, 4, group=group)
    xq, xs = jq.quant_act_grouped(jnp.asarray(x), n_groups)
    xq, xs = np.array(xq), np.array(xs)
    pallas = np.asarray(jq.int4_matmul_s8(xq, xs, q["w_q4"], q["scale4"], block_n=128,
                                          interpret=True), np.float32)
    got = tq.int4_matmul_s8_reference(*map(torch.from_numpy, (xq, xs, q["w_q4"],
                                                              q["scale4"])))
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    # bit-equal to the kernel's math in numpy: exact integer dots, then
    # acc + dot·(xs·ws) in f32, groups in order
    packed = q["w_q4"].astype(np.int32)
    w = np.concatenate([(packed << 28) >> 28, packed >> 4]).reshape(n_groups, group, n)
    xg = xq.astype(np.int64).reshape(m, n_groups, group)
    acc = np.zeros((m, n), np.float32)
    for g in range(n_groups):
        acc = acc + (xg[:, g] @ w[g]).astype(np.float32) * (xs[:, g:g + 1] * q["scale4"][g:g + 1])
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(jnp.asarray(acc, jnp.bfloat16), np.float32))
    # the Pallas kernel in interpret mode: XLA's fusions flip the odd bf16
    # rounding (one output of 1600 at m = 8)
    assert rel_l2(got.float().numpy(), pallas) <= 1e-3
    # against the bf16-dequant twin: activation quantization noise only
    ref = np.asarray(jq._int4_matmul_xla(jnp.asarray(x), q["w_q4"], q["scale4"]), np.float32)
    assert rel_l2(got.float().numpy(), ref) <= 2e-2


@pytest.mark.parametrize("m,k,n,wide,pairs", [
    (1, 4096, 14336, True, 16),    # 112 column tiles fill the card: no split
    (8, 4096, 14336, True, 16),    # and the 8 rows' terms still fit
    (1, 14336, 4096, True, 8),     # 32 tiles: K split over 7 ranks, a pair a warp, 224 blocks
    (1, 4096, 4096, True, 4),      # 32 tiles × 4 ranks: 8 would be 256 blocks, past a wave
    (1, 4096, 1024, True, 2),      # 8 tiles: 8 ranks (the cluster limit), 64 blocks
    (1, 4096, 6144, True, 4),      # q|k|v fused: 48 tiles × 4 ranks, 192 blocks
    (1, 4096, 28672, True, 16),    # gate|up fused: 224 tiles, no split
    (1, 3072, 5120, True, 4),      # llama-3.2-3b's q|k|v: 40 tiles × 3 ranks (6: 240 blocks)
    (1, 3072, 16384, True, 12),    # its gate|up: 128 tiles, no split
    (3, 256, 1000, False, 1),      # one pair: nothing to split
    (1, 2048, 3648, True, 2),      # Moonlight's q|kv_a: 29 tiles × 4 ranks, 116 blocks
    (1, 2048, 2048, True, 2),      # its o: 16 tiles × 4 ranks
    (1, 11264, 2048, True, 8)])    # its layer-0 dense down: 44 pairs, 6 ranks of 8
def test_s8_plan_splits_k_only_to_fill_the_card(m, k, n, wide, pairs):
    n_groups = k // 128
    assert tq.s8_pairs_per_block(m, k, n, n_groups, wide) == pairs
    # whatever the shape, a block takes all of the pairs, or a split of at
    # most S8_MAX_CLUSTER ranks of 2, 4 or a multiple of 8 pairs (its 8
    # warps share them evenly) whose shared memory fits; at one row of M
    # the grid fits one wave
    for m2, n2 in ((m, n), (1, 64), (8, 4096), (40, 96), (1, 128256)):
        wide2 = n2 % 16 == 0
        pb = tq.s8_pairs_per_block(m2, k, n2, n_groups, wide2)
        half = n_groups // 2
        if pb == half:
            continue
        splits = -(-half // pb)
        bn = tq.S8_BLOCK_N[0] if wide2 else tq.S8_BLOCK_N[1]
        assert pb in (2, 4) or pb % 8 == 0
        assert 2 <= splits <= tq.S8_MAX_CLUSTER
        assert tq.s8_layout_bytes(min(m2, 8), pb, k // n_groups, bn, n_groups,
                                  splits) <= tq.S8_MAX_SMEM
        if m2 == 1:
            assert -(-n2 // bn) * splits <= tq.S8_WAVE_BLOCKS


def _cluster_fold(xq, xs, w_q4, scale4, pb, bn=128):
    """int4_matmul_s8's split fold, mirrored in torch: the ranks of a
    split take runs of pb group pairs (the low nibbles' group p and the
    high nibbles' p + n_groups/2); each rank's terms f32(d) · (xs · ws)
    go to the rank that folds their columns (runs of s8_fold_cols of each
    bn-column tile), which adds its n_groups terms in group order."""
    m, k = xq.shape
    n, n_groups = w_q4.shape[1], scale4.shape[0]
    half, group = n_groups // 2, k // n_groups
    splits = -(-half // pb)
    cols = tq.s8_fold_cols(bn, splits)
    lo, hi = tq._unpack_int4(w_q4)
    nibbles = torch.cat([lo, hi]).long().reshape(n_groups, group, n)
    xg = xq.long().reshape(m, n_groups, group)
    # received[q][g]: the (m, n) terms of group g that rank q holds
    received = [{} for _ in range(splits)]
    for rank in range(splits):
        pairs = range(rank * pb, min(half, (rank + 1) * pb))
        for g in [*pairs, *(half + p for p in pairs)]:
            term = (xg[:, g] @ nibbles[g]).float() * (xs[:, g:g + 1] * scale4[g:g + 1])
            for c in range(0, n, 4):
                q = (c % bn) // cols
                received[q].setdefault(g, torch.zeros(m, n))[:, c:c + 4] = term[:, c:c + 4]
    out = torch.zeros(m, n)
    for c in range(n):
        q = (c % bn) // cols
        acc = torch.zeros(m)
        for g in range(n_groups):
            acc = acc + received[q][g][:, c]
        out[:, c] = acc
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("pb", [1, 2, 4, 8])
@pytest.mark.parametrize("m,n", [(1, 264), (3, 136)])
def test_cluster_fold_mirror_equals_plain_version(m, n, pb):
    """16 groups of 16 (8 pairs) over 2-3 column tiles, the last ragged:
    1, 2 or 4 pairs a rank (8, 4, 2 ranks) and all 8 (no split)."""
    x, q = _inputs(m, 256, n, 4, group=16)
    xq, xs = tq.quant_act_grouped(torch.from_numpy(x), 16)
    w_q4, scale4 = torch.from_numpy(q["w_q4"]), torch.from_numpy(q["scale4"])
    assert torch.equal(_cluster_fold(xq, xs, w_q4, scale4, pb),
                       tq.int4_matmul_s8_reference(xq, xs, w_q4, scale4))


def _int4_path_shapes():
    """chip_smoke.py's int4_matmul shapes, and the prefill's at M = 1748
    (the longest stage prompt)."""
    import chip_smoke

    shapes = sorted({s[:3] for s in chip_smoke.QUANT_SHAPES["int4_matmul"]})
    return shapes + sorted({(chip_smoke.LLM_LONG_PROMPT, k, n) for _, k, n in shapes})


@pytest.mark.parametrize("m,k,n", _int4_path_shapes() + [(1, 4096, 14336), (1, 16, 4)])
def test_int4_plan_fills_the_card_or_splits(m, k, n):
    """Every shape either has at least INT4_SMS blocks or splits K; a
    split is a cluster of 2 or 4 blocks with at least one chunk of K
    each, and only shapes short of INT4_SMS tiles split."""
    split = tq.int4_plan(m, k, n)
    tiles = -(-m // tq.INT4_BLOCK[0]) * -(-n // tq.INT4_BLOCK[1])
    chunks = -(-(k // 2) // tq.INT4_CHUNK)
    assert split in (1, 2, 4)
    assert tiles * split >= tq.INT4_SMS or split > 1 or chunks < 2
    if split > 1:
        assert tiles < tq.INT4_SMS and chunks // split >= 1
    if tiles >= tq.INT4_SMS:
        assert split == 1


def test_int4_s8_rejects_groups_the_kernel_cannot_split():
    """The kernel takes G a multiple of 4 (a lane's 4-row dp4a stays in
    one group): the wrapper's checks refuse other shapes before a launch;
    the plain version still runs them on the CPU."""
    w = torch.randn(48, 8)
    q = tq.quantize_int4(w, group=6)          # 8 groups of 6: the CPU path is fine
    xq, xs = tq.quant_act_grouped(torch.randn(1, 48), 8)
    assert tq.int4_matmul_s8(xq, xs, q["w_q4"], q["scale4"]).shape == (1, 8)
    with pytest.raises(ValueError, match="multiple of 4"):
        tq._check_int4_s8(xq, xs, q["w_q4"], q["scale4"])
    q8 = tq.quantize_int4(w, group=8)
    xq, xs = tq.quant_act_grouped(torch.randn(1, 48), 6)
    assert tq._check_int4_s8(xq, xs, q8["w_q4"], q8["scale4"]) == (1, 48, 8, 6)


def tpu_route(x, wp):
    """The JAX package's matmul_any as it routes on the TPU (quant.py:
    322-351), with the Pallas kernels in interpret mode."""
    lead, k = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, k)
    m = xf.shape[0]
    if "w_q4" in wp:
        if m <= 8:
            xq, xs = jq.quant_act_grouped(xf, wp["scale4"].shape[0])
            out = jq.int4_matmul_s8(xq, xs, wp["w_q4"], wp["scale4"],
                                    interpret=True).astype(x.dtype)
        else:
            out = jq.int4_matmul(xf, wp["w_q4"], wp["scale4"], interpret=True)
    elif "w_q" in wp:
        out = (jq._int8_matmul_xla(xf, wp["w_q"], wp["scale"]) if m <= 8 else
               jq.int8_matmul(xf, wp["w_q"], wp["scale"], interpret=True))
    else:
        return x @ wp["w"].astype(x.dtype)
    return out.reshape(*lead, -1)


@pytest.mark.parametrize("kind", ["dense", "int8", "int4"])
@pytest.mark.parametrize("rows", [(1,), (2, 4), (3, 3), (2, 5)])   # m = 1, 8, 9, 10
def test_matmul_any_routes_as_the_tpu(kind, rows, monkeypatch):
    rng = np.random.default_rng(6)
    x = rng.standard_normal(rows + (128,)).astype(np.float32)
    w = (rng.standard_normal((128, 96)) * 0.1).astype(np.float32)
    wp = {"dense": {"w": w}, "int8": jq.quantize_int8(w),
          "int4": jq.quantize_int4(w, group=32)}[kind]
    ref = np.asarray(tpu_route(jnp.asarray(x), wp))
    calls = []
    for name in ("int8_matmul", "int4_matmul", "int4_matmul_s8", "_int8_matmul_xla"):
        fn = getattr(tq, name)
        monkeypatch.setattr(tq, name, lambda *a, _fn=fn, _name=name:
                            calls.append(_name) or _fn(*a))
    got = tq.matmul_any(torch.from_numpy(x), {k: torch.from_numpy(np.array(v))
                                              for k, v in wp.items()})
    assert got.shape == rows + (96,) and got.dtype == torch.float32
    assert rel_l2(got.numpy(), ref) <= 1e-5
    m = int(np.prod(rows))
    expected = {"dense": [], "int8": ["_int8_matmul_xla" if m <= 8 else "int8_matmul"],
                "int4": ["int4_matmul_s8" if m <= 8 else "int4_matmul"]}[kind]
    assert calls == expected


def test_wrappers_run_plain_versions_on_cpu():
    x, q = _inputs(9, 256, 200, 4, group=32)
    xt = torch.from_numpy(x)
    wq, s = torch.from_numpy(q["w_q4"]), torch.from_numpy(q["scale4"])
    tq.reset_launch_counts()
    torch.testing.assert_close(tq.int4_matmul(xt, wq, s), tq.int4_matmul_reference(xt, wq, s),
                               rtol=0, atol=0)
    xq, xs = tq.quant_act_grouped(xt, 8)
    torch.testing.assert_close(tq.int4_matmul_s8(xq, xs, wq, s),
                               tq.int4_matmul_s8_reference(xq, xs, wq, s), rtol=0, atol=0)
    x8, q8 = _inputs(9, 128, 200, 8)
    args = [torch.from_numpy(a) for a in (x8, q8["w_q"], q8["scale"])]
    torch.testing.assert_close(tq.int8_matmul(*args), tq.int8_matmul_reference(*args),
                               rtol=0, atol=0)
    # the counts record kernel launches only
    assert tq.launch_counts == {"int8_matmul": 0, "int4_matmul": 0, "int4_matmul_s8": 0,
                                "int4_moe_s8": 0, "int4_group_matmul": 0}
    assert not any(tq.cluster_launch_counts.values())


def test_cluster_launches_count_apart_from_launches():
    """A split launch's count has a name of its own, so a graph capture's
    record (keyed by name) keeps it apart from the kernel's launches, and
    each replay adds both."""
    from turbo_whisper_workspace_tpu_torch.ops import build as tbuild

    tq.reset_launch_counts()
    tq.s8_cluster_launch("int4_matmul_s8")
    assert tq.cluster_launch_counts == {"int4_matmul_s8.cluster": 1, "int4_moe_s8.cluster": 0}
    tbuild.capture.record = record = {}
    try:
        tbuild.count_launch(tq.launch_counts, "int4_matmul_s8")
        tq.s8_cluster_launch("int4_matmul_s8")
    finally:
        tbuild.capture.record = None
    for name, (counts, n) in record.items():      # one replay, as StepGraph.replay adds
        counts[name] += n
    assert tq.launch_counts["int4_matmul_s8"] == 1
    assert tq.cluster_launch_counts["int4_matmul_s8.cluster"] == 2
    tq.reset_launch_counts()
    assert not any(tq.cluster_launch_counts.values())


def test_wrappers_name_their_launches():
    """Each wrapper passes as many arguments as its C signature declares."""
    from turbo_whisper_workspace_tpu_torch.ops import build

    tree = ast.parse(pathlib.Path(tq.__file__).read_text())
    calls = {c.args[0].value: len(c.args) - 1 for c in ast.walk(tree)
             if isinstance(c, ast.Call) and getattr(c.func, "attr", "") == "launch"}
    assert calls == {n: len(build.SIGNATURES[n]) for n in tq.launch_counts}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs these checks on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(3, 256, 1000), (70, 512, 264), (1, 4096, 1024)])
def test_cuda_quant_kernels_match_plain_versions(cuda_device, m, k, n):
    gen = torch.Generator(cuda_device).manual_seed(0)
    x = torch.randn(m, k, generator=gen, device=cuda_device).to(torch.bfloat16)
    w = torch.randn(k, n, generator=gen, device=cuda_device) * k ** -0.5
    q8, q4 = tq.quantize_int8(w), tq.quantize_int4(w, group=32)

    def check(got, ref):
        assert torch.isfinite(got.float()).all()
        assert (got.float() - ref.float()).norm() <= 5e-3 * ref.float().norm()

    check(tq.int8_matmul(x, q8["w_q"], q8["scale"]),
          tq.int8_matmul_reference(x, q8["w_q"], q8["scale"]))
    check(tq.int4_matmul(x, q4["w_q4"], q4["scale4"]),
          tq.int4_matmul_reference(x, q4["w_q4"], q4["scale4"]))
    xq, xs = tq.quant_act_grouped(x, k // 32)
    # bit-equal: (1, 4096, 1024) splits K over blocks, (3, 256, 1000) has
    # rows 1000 bytes apart (4-byte loads)
    assert torch.equal(tq.int4_matmul_s8(xq, xs, q4["w_q4"], q4["scale4"]),
                       tq.int4_matmul_s8_reference(xq, xs, q4["w_q4"], q4["scale4"]))
    q128 = tq.quantize_int4(w, group=128)
    xq, xs = tq.quant_act_grouped(x, k // 128)
    assert torch.equal(tq.int4_matmul_s8(xq, xs, q128["w_q4"], q128["scale4"]),
                       tq.int4_matmul_s8_reference(xq, xs, q128["w_q4"], q128["scale4"]))


@pytest.mark.cuda
@pytest.mark.parametrize("widths,pairs", [((4096, 1024, 1024), 4), ((14336, 14336), 16)])
def test_cuda_fused_int4_s8_launch_equals_separate_launches(cuda_device, widths, pairs):
    """One launch over sibling weights side by side (the 8B layer's q|k|v,
    whose plan splits K, and gate|up, whose plan does not) equals their
    separate launches bit for bit: a column's s32 dots and their fold in
    group order do not depend on the grid."""
    k, groups = 4096, 32
    gen = torch.Generator(cuda_device).manual_seed(len(widths))
    x = torch.randn(1, k, generator=gen, device=cuda_device).to(torch.bfloat16)
    xq, xs = tq.quant_act_grouped(x, groups)
    parts = [tq.quantize_int4(torch.randn(k, n, generator=gen, device=cuda_device) * k ** -0.5)
             for n in widths]
    w_q4 = torch.cat([p["w_q4"] for p in parts], 1)
    scale4 = torch.cat([p["scale4"] for p in parts], 1)
    assert tq.s8_pairs_per_block(1, k, sum(widths), groups, True) == pairs
    before = tq.launch_counts["int4_matmul_s8"]
    got = tq.int4_matmul_s8(xq, xs, w_q4, scale4)
    assert tq.launch_counts["int4_matmul_s8"] == before + 1
    separate = [tq.int4_matmul_s8(xq, xs, p["w_q4"], p["scale4"]) for p in parts]
    assert torch.equal(got, torch.cat(separate, 1))


# the decode step's four shapes (q|k|v, out, gate|up, down), Moonlight's
# three split ones (q|kv_a, o, layer 0's dense down), the route's M = 8 and
# a ragged shape with 4-byte loads
S8_CARD_SHAPES = [(1, 4096, 6144), (1, 4096, 4096), (1, 4096, 28672), (1, 14336, 4096),
                  (1, 2048, 3648), (1, 2048, 2048), (1, 11264, 2048), (8, 4096, 14336),
                  (8, 14336, 4096), (3, 256, 1000)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", S8_CARD_SHAPES)
def test_cuda_int4_s8_cluster_fold_is_bit_equal(cuda_device, m, k, n):
    """Every plan, split over a cluster or not, equals the plain version
    bit for bit; a launch that splits K is counted as a cluster launch,
    and its grid fits the clusters the card holds at once where the plan
    aims for one wave."""
    group = min(128, k // 2)
    gen = torch.Generator(cuda_device).manual_seed(k + n)
    q = tq.quantize_int4(torch.randn(k, n, generator=gen, device=cuda_device) * k ** -0.5,
                         group=group)
    xq, xs = tq.quant_act_grouped(torch.randn(m, k, generator=gen, device=cuda_device),
                                  k // group)
    n_groups = k // group
    pb = tq.s8_pairs_per_block(m, k, n, n_groups, n % 16 == 0)
    before = tq.cluster_launch_counts["int4_matmul_s8.cluster"]
    got = tq.int4_matmul_s8(xq, xs, q["w_q4"], q["scale4"])
    splits = tq.cluster_launch_counts["int4_matmul_s8.cluster"] - before
    assert splits == (pb < n_groups // 2)
    assert torch.equal(got, tq.int4_matmul_s8_reference(xq, xs, q["w_q4"], q["scale4"]))
    if splits and m == 1:
        tiles = -(-n // tq.S8_BLOCK_N[0])
        assert tiles <= tq.s8_resident_clusters(m, k, n, n_groups, pb)


@pytest.mark.cuda
def test_cuda_int4_s8_cluster_fold_replays_in_a_graph(cuda_device):
    """q|k|v's split launch captured once, replayed on new inputs copied
    into the captured ones: each replay equals the plain version."""
    k, n, groups = 4096, 6144, 32
    gen = torch.Generator(cuda_device).manual_seed(3)
    q = tq.quantize_int4(torch.randn(k, n, generator=gen, device=cuda_device) * k ** -0.5)
    assert tq.s8_pairs_per_block(1, k, n, groups, True) < groups // 2
    xq, xs = tq.quant_act_grouped(torch.randn(1, k, generator=gen, device=cuda_device), groups)
    tq.int4_matmul_s8(xq, xs, q["w_q4"], q["scale4"])       # warm-up, outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tq.int4_matmul_s8(xq, xs, q["w_q4"], q["scale4"])
    for _ in range(3):
        new_q, new_s = tq.quant_act_grouped(
            torch.randn(1, k, generator=gen, device=cuda_device), groups)
        xq.copy_(new_q)
        xs.copy_(new_s)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, tq.int4_matmul_s8_reference(new_q, new_s, q["w_q4"],
                                                            q["scale4"]))


@pytest.mark.cuda
def test_cuda_int4_moe_s8_splits_over_a_cluster(cuda_device):
    """The expert product at a shape whose plan splits K (2 rows, 1408 →
    2048 in groups of 64: 16 tiles a row, 6 ranks of 2 pairs): bit-equal
    to its plain version, counted as a cluster launch."""
    k, n, group = 1408, 2048, 64
    gen = torch.Generator(cuda_device).manual_seed(4)
    w = tq.quantize_int4(torch.randn(5, k, n, generator=gen, device=cuda_device) * k ** -0.5,
                         group=group)
    xq, xs = tq.quant_act_grouped(torch.randn(2, k, generator=gen, device=cuda_device),
                                  k // group)
    ids = torch.tensor([3, 0], device=cuda_device)
    assert tq.s8_pairs_per_block(2, k, n, k // group, True, rows_per_block=1) == 2
    before = tq.cluster_launch_counts["int4_moe_s8.cluster"]
    got = tq.int4_moe_s8(xq, xs, w["w_q4"], w["scale4"], ids)
    assert tq.cluster_launch_counts["int4_moe_s8.cluster"] == before + 1
    assert torch.equal(got, tq.int4_moe_s8_reference(xq, xs, w["w_q4"], w["scale4"], ids))


@pytest.mark.cuda
@pytest.mark.parametrize("group", [32, 64, 128])
@pytest.mark.parametrize("m,k,n", [(1748, 512, 1000), (3, 1024, 264), (512, 4096, 1024),
                                   (130, 256, 4096)])
def test_cuda_int4_matmul_matches_plain_version(cuda_device, m, k, n, group):
    """int4_matmul's wgmma kernel: ragged M (not a multiple of 128) and N
    (4-byte weight copies where N % 16 != 0), group sizes 32 to 128, and
    K split over a cluster ((512, 4096, 1024): 4 blocks a tile)."""
    gen = torch.Generator(cuda_device).manual_seed(group)
    x = torch.randn(m, k, generator=gen, device=cuda_device).to(torch.bfloat16)
    q = tq.quantize_int4(torch.randn(k, n, generator=gen, device=cuda_device) * k ** -0.5,
                         group=group)
    got = tq.int4_matmul(x, q["w_q4"], q["scale4"]).float()
    ref = tq.int4_matmul_reference(x, q["w_q4"], q["scale4"]).float()
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= 2e-2 * ref.abs().max()
    assert (got - ref).norm() <= 5e-3 * ref.norm()
    if (m, k, n) == (512, 4096, 1024):
        assert tq.int4_plan(m, k, n) == 4


# ---------------------------------------------------------------------------
# int8_matmul's plan and its split-K folds (csrc/int8_matmul.cu)


@pytest.mark.parametrize("m,k,n,regime", [
    (1, 4096, 128256, "gemv"),       # the 8B head at a decode step
    (1, 3072, 1024, "gemv"),         # llama-3.2-3b's k/v projection: 8 column tiles
    (8, 4096, 14336, "gemv"),        # the m ≤ 8 route's largest M
    (9, 4096, 14336, "wgmma"),
    (512, 4096, 128256, "wgmma"),    # the prefill head
    (1748, 4096, 128256, "wgmma"),   # the longest stage prompt's
    (3, 256, 1000, "gemv"), (70, 512, 264, "wgmma"), (1, 8, 4, "gemv")])   # ragged
def test_int8_plan_regimes_and_splits(m, k, n, regime):
    """The regime follows M; a split covers K's steps (or chunks) exactly
    once, rank by rank in order; the GEMV splits only while the column
    tiles leave the card short of blocks and every warp keeps a step;
    the ring splits as int4_matmul's does."""
    got, split = tq.int8_plan(m, k, n)
    assert got == regime
    if regime == "gemv":
        steps = -(-k // tq.INT8_GEMV_STEP)
        tiles = -(-n // tq.GEMV_COLS)
        assert split in (1, 2, 4, 8)
        assert tiles * split <= tq.GEMV_BLOCKS or split == 1
        assert split == 1 or steps >= split * tq.GEMV_WARPS
    else:
        steps = -(-k // tq.INT8_CHUNK)
        assert split == tq._ring_split(m, n, steps) and split in (1, 2, 4)
    ranges = tq.split_ranges(steps, split)
    assert [i for r in ranges for i in r] == list(range(steps))
    assert all(len(r) >= 1 for r in ranges)
    if (m, k, n) == (1, 3072, 1024):
        assert split == 8                # 8 tiles × 8 ranks
    if n == 128256:
        assert split == 1                # 1002 tiles (2004 at M = 512) fill the card


def int8_split_mirror(x, w_q, scale):
    """int8_matmul's sums in the kernel's order, in torch on the CPU: W
    rounded to bf16 per element as the kernel dequantizes it; f32
    partials of each K step (GEMV: 16 rows, a warp taking every 8th step
    of its rank's slice, the warps folded in order) or chunk (ring: 64
    rows); each rank's partial folded over the ranks in rank order; one
    rounding to bf16."""
    m, k = x.shape
    regime, split = tq.int8_plan(m, k, w_q.shape[1])
    w = (w_q.to(torch.bfloat16) * scale.to(torch.bfloat16)).float()
    xb = x.to(torch.bfloat16).float()
    rows = tq.INT8_GEMV_STEP if regime == "gemv" else tq.INT8_CHUNK
    steps = -(-k // rows)

    def part(s):
        return xb[:, s * rows:(s + 1) * rows] @ w[s * rows:(s + 1) * rows]

    ranks = []
    for r in tq.split_ranges(steps, split):
        if regime == "gemv":
            warps = [sum((part(s) for s in r[wi::tq.GEMV_WARPS]), torch.zeros(m, w.shape[1]))
                     for wi in range(tq.GEMV_WARPS)]
            ranks.append(sum(warps[1:], warps[0]))
        else:
            ranks.append(sum((part(s) for s in r), torch.zeros(m, w.shape[1])))
    return sum(ranks[1:], ranks[0]).to(torch.bfloat16), split


@pytest.mark.parametrize("m,k,n,split", [
    (1, 2048, 256, 8), (3, 512, 200, 4), (8, 1024, 1000, 8),      # the GEMV
    (1, 264, 100, 2), (70, 512, 264, 4), (12, 256, 200, 4)])     # ragged K; the ring
def test_int8_split_fold_matches_reference_and_jax(m, k, n, split):
    """The split-K fold of both regimes against int8_matmul_reference
    and the JAX Pallas kernel in interpret mode, on the same bf16 inputs
    (bf16 outputs: relative L2 within 5e-3, max abs within 2e-2 ×
    max|ref|, chip_smoke.py's limits)."""
    x, q = _inputs(m, k, n, 8, dtype="bfloat16")
    xj, xt = _x_pair(x, "bfloat16")
    wq, s = torch.from_numpy(q["w_q"]), torch.from_numpy(q["scale"])
    got, got_split = int8_split_mirror(xt, wq, s)
    assert got_split == split
    ref = tq.int8_matmul_reference(xt, wq, s).float().numpy()
    pallas = np.asarray(jq.int8_matmul(xj, q["w_q"], q["scale"], block_n=128, interpret=True),
                        np.float32)
    for other in (ref, pallas):
        assert rel_l2(got.float().numpy(), other) <= 5e-3
        assert np.abs(got.float().numpy() - other).max() <= 2e-2 * np.abs(other).max()
    # a wrong column's scale reads above the limit
    wrong = tq.int8_matmul_reference(xt, wq, s.roll(1)).float().numpy()
    assert rel_l2(wrong, ref) > 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 8, 9, 17, 64, 512])
@pytest.mark.parametrize("k,n", [(1000, 4104), (3072, 1024), (264, 1000)])
def test_cuda_int8_matmul_both_regimes_match_plain_version(cuda_device, m, k, n):
    """int8_matmul's GEMV (M ≤ 8) and wgmma ring (M > 8) regimes: ragged
    K (not a multiple of 16 or 64) and N (4-byte loads at N % 16 != 0),
    K split over a cluster ((3072, 1024): 8 ranks at M ≤ 8, 4 at M ≤
    256), the same bytes from run to run, and a wrong column's scale
    read above the limit."""
    gen = torch.Generator(cuda_device).manual_seed(m)
    x = torch.randn(m, k, generator=gen, device=cuda_device).to(torch.bfloat16)
    q = tq.quantize_int8(torch.randn(k, n, generator=gen, device=cuda_device) * k ** -0.5)
    got = tq.int8_matmul(x, q["w_q"], q["scale"])
    assert torch.equal(got, tq.int8_matmul(x, q["w_q"], q["scale"]))
    got = got.float()
    ref = tq.int8_matmul_reference(x, q["w_q"], q["scale"]).float()
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= 2e-2 * ref.abs().max()
    assert (got - ref).norm() <= 5e-3 * ref.norm()
    wrong = tq.int8_matmul_reference(x, q["w_q"], q["scale"].roll(1)).float()
    assert (wrong - ref).norm() > 5e-3 * ref.norm()
    if (k, n) == (3072, 1024):
        assert tq.int8_plan(m, k, n)[1] > 1


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [(1,), (2, 4), (3, 3)])   # m = 1, 8, 9
def test_cuda_matmul_any_int8_routes_to_the_kernel(cuda_device, rows, monkeypatch):
    """On the card every int8 projection goes to int8_matmul (the GEMV
    regime at m ≤ 8, in place of the dequant matmul the CPU route keeps),
    within the kernel limits of the dequant route's result."""
    gen = torch.Generator(cuda_device).manual_seed(7)
    x = torch.randn(*rows, 4096, generator=gen, device=cuda_device).to(torch.bfloat16)
    wp = tq.quantize_int8(torch.randn(4096, 1000, generator=gen, device=cuda_device) * 0.02)
    calls = []
    for name in ("int8_matmul", "_int8_matmul_xla"):
        fn = getattr(tq, name)
        monkeypatch.setattr(tq, name, lambda *a, _fn=fn, _name=name:
                            calls.append(_name) or _fn(*a))
    got = tq.matmul_any(x, wp).float()
    assert calls == ["int8_matmul"] and got.shape == rows + (1000,)
    ref = tq._int8_matmul_xla(x.reshape(-1, 4096), wp["w_q"], wp["scale"]).float()
    ref = ref.reshape(got.shape)
    assert (got - ref).abs().max() <= 2e-2 * ref.abs().max()
    assert (got - ref).norm() <= 5e-3 * ref.norm()
