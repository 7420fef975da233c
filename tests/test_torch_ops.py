"""Port ops (turbo_whisper_workspace_tpu_torch/ops) against the JAX package.

The mel frontend, the attention kernels' plain versions, the int8
cross-KV quantizer and the int8 self-KV helpers run on the CPU here, on
the same numpy inputs as their JAX counterparts (Pallas in interpret
mode, or the XLA twin).
The CUDA kernels themselves need a card: the `cuda`-marked test holds
them to the plain versions there.
"""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turbo_whisper_workspace_tpu.ops import attention as jatt
from turbo_whisper_workspace_tpu.models import whisper as jwm
from turbo_whisper_workspace_tpu.ops import mel as jmel
from turbo_whisper_workspace_tpu_torch.ops import attention as tatt
from turbo_whisper_workspace_tpu_torch.ops import build
from turbo_whisper_workspace_tpu_torch.models import whisper as twm
from turbo_whisper_workspace_tpu_torch.ops import mel as tmel
from turbo_whisper_workspace_tpu_torch.ops import whisper_ops as two


@pytest.mark.parametrize("kind", ["float32", "int16"])
def test_log_mel_matches_jax(kind):
    rng = np.random.default_rng(0)
    if kind == "int16":
        audio = (rng.standard_normal((2, 32000)) * 3000).astype(np.int16)
        num_mels = 128
    else:
        audio = (rng.standard_normal((2, 32000)) * 0.1).astype(np.float32)
        num_mels = 80
    ref = np.asarray(jmel.log_mel_spectrogram(audio, num_mels=num_mels))
    got = tmel.log_mel_spectrogram(torch.from_numpy(audio), num_mels).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-4)  # as test_mel.py:41


def test_pad_or_trim_matches_jax():
    x = np.arange(10, dtype=np.float32)
    for n in (4, 10, 16):
        np.testing.assert_array_equal(tmel.pad_or_trim(x, n), jmel.pad_or_trim(x, n))


@pytest.mark.parametrize("t", [256, 1500])
def test_flash_reference_matches_jax(t):
    rng = np.random.default_rng(t)
    b, h, d = 1, 2, 64
    q, k, v = (rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(3))
    got = tatt.flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)).numpy()
    pallas = np.asarray(jatt.flash_attention(q, k, v, interpret=True))
    plain = np.asarray(jatt.attention_reference(q, k, v))
    np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(got, plain, atol=2e-5, rtol=1e-5)


def test_flash_reference_bf16_matches_jax():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((1, 2, 256, 64)).astype(np.float32)
    qj = jnp.asarray(q, jnp.bfloat16)
    ref = np.asarray(jatt.attention_reference(qj, qj, qj), np.float32)
    qt = torch.from_numpy(q).to(torch.bfloat16)
    got = tatt.flash_attention_reference(qt, qt, qt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, atol=2e-2, rtol=2e-2)


def test_quantize_cross_kv_bit_equal_to_jax():
    rng = np.random.default_rng(2)
    k = rng.standard_normal((2, 2, 3, 300, 64)).astype(np.float32)
    v = rng.standard_normal((2, 2, 3, 300, 64)).astype(np.float32)
    ref = jatt.quantize_cross_kv_int8(jnp.asarray(k), jnp.asarray(v))
    got = tatt.quantize_cross_kv_int8(torch.from_numpy(k), torch.from_numpy(v))
    assert got["k_q"].shape == (2, 2, 3, 64, 384)
    assert got["v_q"].shape == (2, 2, 384, 3 * 64)
    for key in ("k_q", "v_q"):
        assert got[key].dtype == torch.int8
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]))
    for key in ("k_scale", "v_scale"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=1e-6)


def _cross_inputs(tq, seed=3):
    rng = np.random.default_rng(seed)
    b, h, t, dh = 2, 4, 300, 64
    k = rng.standard_normal((1, b, h, t, dh)).astype(np.float32)
    v = rng.standard_normal((1, b, h, t, dh)).astype(np.float32)
    q = rng.standard_normal((b, h, tq, dh)).astype(np.float32)
    qkv = jatt.quantize_cross_kv_int8(jnp.asarray(k), jnp.asarray(v))
    return q, {key: np.array(val[0]) for key, val in qkv.items()}, t


@pytest.mark.parametrize("tq", [1, 5])
def test_cross_reference_matches_jax(tq):
    q, kv, t = _cross_inputs(tq)
    args = (kv["k_q"], kv["v_q"], kv["k_scale"], kv["v_scale"])
    got = tatt.cross_attention_int8_reference(
        torch.from_numpy(q), *map(torch.from_numpy, args), seq_len=t).numpy()
    pallas = np.asarray(jatt.cross_attention_int8(
        jnp.asarray(q), *map(jnp.asarray, args), seq_len=t, interpret=True))
    xla = np.asarray(jatt.cross_attention_int8_xla(
        jnp.asarray(q), *map(jnp.asarray, args), seq_len=t))
    assert got.shape == (2, 4, tq, 64)
    # both sides round q and the weights to bf16
    np.testing.assert_allclose(got, pallas, atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(got, xla, atol=2e-2, rtol=2e-2)


# (Tq, Tpad) on the smoke run's paths (greedy 1, the prompt 3, 4, beam 5,
# a longer prompt 35; Tpad 1536) and ragged ones
CROSS_PLAN_CASES = [(tq, 1536) for tq in (1, 3, 4, 5, 35)] + [
    (1, 16), (2, 128), (5, 256), (7, 384), (9, 1664), (1, 8192)]


@pytest.mark.parametrize("tq,tpad", CROSS_PLAN_CASES)
def test_cross_plan_covers_tpad(tq, tpad):
    ranks, slice_keys, rows = tatt.cross_int8_plan(tq, tpad)
    assert 1 <= ranks <= tatt.CLUSTER_MAX_RANKS
    assert slice_keys % 16 == 0 and slice_keys <= tatt.CROSS_MAX_SLICE
    assert ranks * slice_keys >= tpad > (ranks - 1) * slice_keys   # no rank wholly past Tpad
    chunks = -(-tq // rows)                           # chunks of at most 8 rows,
    assert 1 <= rows <= 8 and chunks == -(-tq // 8)   # as few as can be, even
    assert chunks * rows - tq < chunks
    if tpad == 1536:
        assert (ranks, slice_keys) == (8, 192)      # 1280 blocks at B = 8, H = 20
    if tpad <= 128:
        assert ranks == 1


def cluster_mirror(q, kq, vq, k_scale, v_scale, seq_len, ranks):
    """cross_attention_int8's cluster arithmetic in its order, in torch:
    per-slice scores of `ranks` 16-key-aligned slices, each slice's max
    m_r and sum of exp2 against it, the global max M, Σ = Σ_r sum_r ·
    exp2(m_r − M) in rank order, bf16 weights exp2(s − M) · (1/Σ), per-slice
    partial P·V summed in rank order."""
    b, h, tq, dh = q.shape
    tpad = kq.shape[-1]
    width = -(-(-(-tpad // ranks)) // 16) * 16
    qs = (q.float() * (k_scale[:, :, None, None] * dh ** -0.5 * tatt.LOG2E)).to(
        torch.bfloat16).float()
    vh = vq.reshape(b, tpad, h, dh).float()
    slices = [(r * width, min((r + 1) * width, seq_len)) for r in range(-(-tpad // width))]
    slices = [(lo, hi) for lo, hi in slices if hi > lo]     # ranks past seq_len add nothing
    scores = [torch.einsum("bhqd,bhdt->bhqt", qs, kq[..., lo:hi].float()) for lo, hi in slices]
    maxes = [s.amax(-1, keepdim=True) for s in scores]
    sums = [torch.exp2(s - m).sum(-1, keepdim=True) for s, m in zip(scores, maxes)]
    m = maxes[0]
    for mr in maxes[1:]:
        m = torch.maximum(m, mr)
    total = sums[0] * torch.exp2(maxes[0] - m)
    for sr, mr in zip(sums[1:], maxes[1:]):
        total = total + sr * torch.exp2(mr - m)
    out = None
    for (lo, hi), s in zip(slices, scores):
        w = (torch.exp2(s - m) * (1.0 / total)).to(torch.bfloat16).float()
        part = torch.einsum("bhqt,bthd->bhqd", w, vh[:, lo:hi])
        out = part if out is None else out + part
    return (out * v_scale[:, :, None, None]).to(q.dtype)


_CROSS_JAX = {}


@pytest.mark.parametrize("ranks", [1, 2, 3, 8])
@pytest.mark.parametrize("tq", [1, 3, 5])
def test_cross_cluster_order_matches_jax(ranks, tq):
    """The cluster's order of operations, at seq_len 100 < Tpad 384 (the
    ranks past key 100 hold no key), against the JAX Pallas kernel in
    interpret mode, with test_cross_reference_matches_jax's tolerance."""
    seq_len = 100
    q, kv, _ = _cross_inputs(tq)
    args = (kv["k_q"], kv["v_q"], kv["k_scale"], kv["v_scale"])
    if tq not in _CROSS_JAX:
        _CROSS_JAX[tq] = np.asarray(jatt.cross_attention_int8(
            jnp.asarray(q), *map(jnp.asarray, args), seq_len=seq_len, interpret=True))
    got = cluster_mirror(torch.from_numpy(q), *map(torch.from_numpy, args), seq_len, ranks)
    assert got.shape == (2, 4, tq, 64)
    np.testing.assert_allclose(got.numpy(), _CROSS_JAX[tq], atol=2e-2, rtol=2e-2)
    plain = tatt.cross_attention_int8_reference(
        torch.from_numpy(q), *map(torch.from_numpy, args), seq_len=seq_len)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=2e-2, rtol=2e-2)


def _self_inputs(seed=5, b=2, h=3, tq=1, t=16):
    """int8 (B, H, T, 64) cache with per-(head, position) scales."""
    rng = np.random.default_rng(seed)
    kq = rng.integers(-127, 128, (b, h, t, 64)).astype(np.int8)
    vq = rng.integers(-127, 128, (b, h, t, 64)).astype(np.int8)
    ks = (rng.random((b, h, t)) * 0.02 + 0.01).astype(np.float32)
    vs = (rng.random((b, h, t)) * 0.02 + 0.01).astype(np.float32)
    q = rng.standard_normal((b, h, tq, 64)).astype(np.float32)
    return q, kq, ks, vq, vs


def _lane_inputs(seed=6, b=2, h=3, k=4, t=16):
    """Lane panels as tests/test_attention_kernel.py builds them: K panel
    (B, H·64, K·T), V panel (B, K·T, H·64), scales (B, H, K·T), column
    j = lane·T + t, and a random ancestry lane_map (B, K, T)."""
    rng = np.random.default_rng(seed)
    kq = rng.integers(-127, 128, (b, h, k, t, 64)).astype(np.int8)
    vq = rng.integers(-127, 128, (b, h, k, t, 64)).astype(np.int8)
    ks = (rng.random((b, h, k, t)) * 0.02 + 0.01).astype(np.float32)
    vs = (rng.random((b, h, k, t)) * 0.02 + 0.01).astype(np.float32)
    q = rng.standard_normal((b, h, k, 64)).astype(np.float32)
    lane_map = rng.integers(0, k, (b, k, t)).astype(np.int32)
    kp = kq.transpose(0, 1, 4, 2, 3).reshape(b, h * 64, k * t)
    vp = vq.transpose(0, 2, 3, 1, 4).reshape(b, k * t, h * 64)
    return q, kp, ks.reshape(b, h, k * t), vp, vs.reshape(b, h, k * t), lane_map


def _bf16(x):
    """bf16-valued f32 copy of x (what both sides then cast to bf16)."""
    return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)


def _to_torch_bf16(*xs):
    return [torch.from_numpy(x).to(torch.bfloat16) if x.dtype == np.float32
            else torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("valid_len", [1, 11, 16])
def test_self_int8_reference_matches_jax(valid_len):
    q, kq, ks, vq, vs = _self_inputs()
    got = tatt.self_attention_int8_reference(
        *map(torch.from_numpy, (q, kq, ks, vq, vs)), valid_len).numpy()
    mask = (np.arange(16) < valid_len)[None, None, None]
    xla = np.asarray(jatt.self_attention_int8_xla(q, kq, ks, vq, vs, mask))
    np.testing.assert_allclose(got, xla, atol=1e-5, rtol=1e-5)
    # the Pallas kernel at bf16 q and scales: both sides round w·vs to bf16
    qb, ksb, vsb = _bf16(q), _bf16(ks), _bf16(vs)
    pallas = np.asarray(jatt.self_attention_int8(
        jnp.asarray(qb, jnp.bfloat16), kq, jnp.asarray(ksb, jnp.bfloat16), vq,
        jnp.asarray(vsb, jnp.bfloat16), valid_len, interpret=True), np.float32)
    got_bf16 = tatt.self_attention_int8_reference(
        *_to_torch_bf16(qb, kq, ksb, vq, vsb), valid_len)
    assert got_bf16.dtype == torch.bfloat16
    np.testing.assert_allclose(got_bf16.float().numpy(), pallas, atol=2e-2, rtol=2e-2)


def self_int8_scale_split(offset: int, n: int):
    """csrc/self_attention_int8.cu's copy of a row of n bf16 scales that
    starts `offset` bytes past a 16-byte boundary: (the byte offsets, from
    that boundary, of the 16-byte cp.async chunks of its aligned interior;
    the elements at its edges, taken by plain loads)."""
    lo = -(-offset // 16) * 16
    hi = (offset + 2 * n) // 16 * 16
    if lo >= hi:
        return [], list(range(n))
    return list(range(lo, hi, 16)), [*range((lo - offset) // 2), *range((hi - offset) // 2, n)]


def _butterfly(v: torch.Tensor, offsets) -> torch.Tensor:
    """v[..., lane] after `v += shfl_xor(v, off)` for each offset, lanes
    in the last dimension."""
    lanes = torch.arange(v.shape[-1])
    for off in offsets:
        v = v + v[..., lanes ^ off]
    return v


def self_int8_tile_mirror(q, kq, ks, vq, vs, valid_len: int):
    """csrc/self_attention_int8.cu's arithmetic in its order, in f32, for
    contiguous (B, H, ...) inputs whose scale rows start at b·h·T·2 bytes
    from a 16-byte boundary: each scale row split into its aligned
    interior and edges (held to cover the row once); scores in passes of
    32 keys, four lanes a key each summing 16 dims, then two shuffles;
    the max; exp2 and the sum, a thread a key (t mod 128), a warp's
    butterfly and the 4 warps in order; weights bf16(p · (1/Σ) · vs);
    P·V four lanes a key (t mod 32) over 16 dims each, the warp's 8 keys
    by butterfly, the 4 warps in order; bf16 out."""
    b, h, tq, d = q.shape
    t_len = kq.shape[2]
    out = torch.empty(b, h, tq, d, dtype=torch.bfloat16)
    for bh in range(b * h):
        bi, hi = divmod(bh, h)
        offset = bh * t_len * 2 % 16
        chunks, edges = self_int8_scale_split(offset, valid_len)
        from_chunks = [i for c in chunks for i in range((c - offset) // 2, (c - offset) // 2 + 8)]
        assert sorted(from_chunks + edges) == list(range(valid_len))
        assert len(edges) <= 15 and (not chunks or len(edges) <= 14)
        k_rows = kq[bi, hi, :valid_len].float()          # the keys a block copies
        v_rows = vq[bi, hi, :valid_len].float()
        ks_row = ks[bi, hi, :valid_len].float()
        vs_row = vs[bi, hi, :valid_len].float()
        for r in range(tq):
            qv = q[bi, hi, r].float()
            part = (k_rows * qv).reshape(valid_len, 4, 16).sum(-1)      # lane sums
            s = (part[:, 0] + part[:, 1]) + (part[:, 2] + part[:, 3])
            s = s * (ks_row * tatt.LOG2E / 8.0)
            p = torch.exp2(s - s.max())
            per_thread = torch.zeros(128)                 # thread t mod 128
            for t0 in range(0, valid_len, 128):
                chunk = p[t0:t0 + 128]
                per_thread[:len(chunk)] += chunk
            warps = _butterfly(per_thread.reshape(4, 32), (16, 8, 4, 2, 1))[:, 0]
            total = ((warps[0] + warps[1]) + warps[2]) + warps[3]
            w = (p * (1.0 / total) * vs_row).to(torch.bfloat16).float()
            acc = torch.zeros(32, d)
            for t0 in range(0, valid_len, 32):
                rows = slice(t0, min(t0 + 32, valid_len))
                acc[:rows.stop - t0] += w[rows, None] * v_rows[rows]
            # lane 4·(key % 8) + sub of warp key // 8 holds dims 16·sub ..
            lanes = acc.reshape(4, 8, 4, 16).permute(0, 3, 1, 2).reshape(4, 16, 32)
            warps = _butterfly(lanes, (4, 8, 16))[:, :, :4]              # (warp, i, sub)
            o = ((warps[0] + warps[1]) + warps[2]) + warps[3]
            out[bi, hi, r] = o.transpose(0, 1).reshape(d).to(torch.bfloat16)
    return out


@pytest.mark.parametrize("valid_len,tq", [(1, 1), (101, 1), (227, 1), (115, 2)])
def test_self_int8_tile_mirror_matches_jax(valid_len, tq):
    """The kernel's tiling at the beam path's T = 227 (scale rows that
    start 6 bytes apart from one (b, h) to the next: interiors and edges
    of every offset) against the JAX Pallas kernel in interpret mode and
    the plain version; the same bf16 rounding points, sums in another
    order."""
    q, kq, ks, vq, vs = _self_inputs(seed=9, b=2, h=3, tq=tq, t=227)
    qb, ksb, vsb = _bf16(q), _bf16(ks), _bf16(vs)
    args = _to_torch_bf16(qb, kq, ksb, vq, vsb)
    got = self_int8_tile_mirror(*args, valid_len).float()
    pallas = np.asarray(jatt.self_attention_int8(
        jnp.asarray(qb, jnp.bfloat16), kq, jnp.asarray(ksb, jnp.bfloat16), vq,
        jnp.asarray(vsb, jnp.bfloat16), valid_len, interpret=True), np.float32)
    np.testing.assert_allclose(got.numpy(), pallas, atol=2e-2, rtol=2e-2)
    ref = tatt.self_attention_int8_reference(*args, valid_len).float()
    assert (got - ref).abs().max() <= 2e-2
    assert (got - ref).norm() <= 5e-3 * ref.norm()
    if valid_len < 227:       # the keys past valid_len matter
        unmasked = tatt.self_attention_int8_reference(*args, 227).float()
        assert (unmasked - ref).norm() > 5e-3 * ref.norm()


@pytest.mark.parametrize("offset,n", [(0, 1), (6, 1), (14, 7), (2, 115), (10, 227),
                                      (0, 448), (8, 8)])
def test_self_int8_scale_split_covers_the_row(offset, n):
    chunks, edges = self_int8_scale_split(offset, n)
    from_chunks = [i for c in chunks for i in range((c - offset) // 2, (c - offset) // 2 + 8)]
    assert sorted(from_chunks + edges) == list(range(n))
    assert all(c % 16 == 0 and offset <= c and c + 16 <= offset + 2 * n for c in chunks)
    assert len(edges) <= 15


@pytest.mark.parametrize("valid_len", [11, 16])
def test_lanes_reference_matches_jax(valid_len):
    q, kp, kps, vp, vps, lane_map = _lane_inputs()
    got = tatt.self_attention_int8_lanes_reference(
        *map(torch.from_numpy, (q, kp, kps, vp, vps, lane_map)), valid_len).numpy()
    xla = np.asarray(jatt.self_attention_int8_lanes_xla(
        q, kp, kps, vp, vps, lane_map, valid_len))
    np.testing.assert_allclose(got, xla, atol=1e-5, rtol=1e-5)
    # the Pallas kernel casts q to bf16 first; at bf16 inputs the two agree
    qb, ksb, vsb = _bf16(q), _bf16(kps), _bf16(vps)
    pallas = np.asarray(jatt.self_attention_int8_lanes(
        jnp.asarray(qb, jnp.bfloat16), kp, jnp.asarray(ksb, jnp.bfloat16), vp,
        jnp.asarray(vsb, jnp.bfloat16), lane_map, valid_len, interpret=True), np.float32)
    got_bf16 = tatt.self_attention_int8_lanes_reference(
        *_to_torch_bf16(qb, kp, ksb, vp, vsb, lane_map), valid_len)
    np.testing.assert_allclose(got_bf16.float().numpy(), pallas, atol=2e-2, rtol=2e-2)


def lanes_mirror(q, kp, ks, vp, vs, lane_map, valid_len, slice_t):
    """self_attention_int8_lanes's cluster arithmetic in its order, in
    torch: the cache's positions split into slices of `slice_t` (rank r
    holds [r·S, (r+1)·S): the plan depends on T alone), each cut at
    valid_len; a rank wholly past valid_len adds −inf to the max, 0 to
    the sum and 0 to P·V, so it is left out here; in each rank's slice,
    the owned (lane, t) pairs, lane-major, with their owner masks; each
    pair scored once for all its owners (f32, × ks·d^-1/2·log2 e, −inf for
    the beams that do not own it); each rank's per-beam max m_r and sum of
    exp2 against it; the global M and Σ = Σ_r sum_r · exp2(m_r − M) in
    rank order; weights bf16(exp2(s − M) · (1/Σ) · vs) against the
    global M; f32 partials of P·V summed in rank order."""
    b, h, k, dh = q.shape
    kt = kp.shape[-1]
    t_len = kt // k
    width = slice_t
    scale = dh ** -0.5 * tatt.LOG2E
    lanes = torch.arange(k)
    out = torch.zeros((b, h, k, dh))
    for bi in range(b):
        kb = kp[bi].reshape(h, dh, kt).float()
        vb = vp[bi].reshape(kt, h, dh).float()
        parts = []
        for lo in range(0, valid_len, width):
            hi = min(lo + width, valid_len)
            lm = lane_map[bi, :, lo:hi].long()                      # (K beams, nt)
            owners = lm[None] == lanes[:, None, None]               # (K lanes, K beams, nt)
            l_idx, t_idx = owners.any(1).nonzero(as_tuple=True)     # lane-major pairs
            cols = l_idx * t_len + lo + t_idx
            own = owners[l_idx, :, t_idx].T                          # (K beams, P)
            s = torch.einsum("hkd,hdp->hkp", q[bi].float(), kb[:, :, cols])
            s = (s * (ks[bi][:, cols].float() * scale)[:, None]).masked_fill(~own, -torch.inf)
            m_r = s.amax(-1, keepdim=True)
            parts.append((cols, s, m_r, torch.exp2(s - m_r).sum(-1, keepdim=True)))
        m = parts[0][2]
        for *_, m_r, _ in parts[1:]:
            m = torch.maximum(m, m_r)
        total = parts[0][3] * torch.exp2(parts[0][2] - m)
        for *_, m_r, sum_r in parts[1:]:
            total = total + sum_r * torch.exp2(m_r - m)
        inv = 1.0 / total
        for cols, s, _, _ in parts:
            w = (torch.exp2(s - m) * inv * vs[bi][:, cols].float()[:, None]).to(q.dtype)
            out[bi] += torch.einsum("hkp,phd->hkd", w.float(), vb[cols])
    return out.to(q.dtype)


# (lanes plan) the cache length T, which alone sizes the launch: the smoke
# run's caches (227, K = 8's 448), short ones and the split's edges; the
# ranks that lie past a smaller valid_len own no position
@pytest.mark.parametrize("t_len", [1, 3, 31, 32, 33, 115, 227, 448, 1000, 1024])
def test_lanes_plan_covers_valid_len(t_len):
    ranks, slice_t = tatt.lanes_plan(t_len)
    assert 1 <= ranks <= tatt.CLUSTER_MAX_RANKS
    assert ranks * slice_t >= t_len > (ranks - 1) * slice_t       # no rank wholly past T
    assert slice_t <= tatt.LANES_MAX_T // tatt.CLUSTER_MAX_RANKS     # fits shared memory
    if t_len <= tatt.LANES_T_PER_RANK:
        assert ranks == 1
    assert {115: (4, 29), 227: (8, 29)}.get(t_len, (ranks, slice_t)) == (ranks, slice_t)


def _lane_map_kind(kind, lane_map):
    """The random lane_map of _lane_inputs, every lane owned (beam k reads
    lane k), or fully coalesced (every beam reads one lane per t)."""
    b, k, t = lane_map.shape
    if kind == "all lanes owned":
        return np.broadcast_to(np.arange(k, dtype=np.int32)[None, :, None], (b, k, t)).copy()
    if kind == "coalesced":
        return np.broadcast_to(lane_map[:, :1], (b, k, t)).copy()
    return lane_map


LANE_MIRROR_CASES = [(k, t, valid, "random") for k in (1, 4, 8) for t in (16, 17)
                     for valid in (1, 11, t)] + [(4, 17, 17, "all lanes owned"),
                                                 (4, 17, 17, "coalesced")]


@pytest.mark.parametrize("k,t,valid_len,kind", LANE_MIRROR_CASES)
def test_lanes_cluster_order_matches_jax(k, t, valid_len, kind):
    """The lanes cluster's order of operations (at its plan for the
    cache length T and T split over 2 and 3 ranks, the ranks past
    valid_len owning nothing) against the JAX package: the XLA twin at
    f32 within 1e-5, and the Pallas kernel in interpret mode on bf16
    inputs within test_lanes_reference_matches_jax's 2e-2. K·T is odd at
    T = 17 and K = 1."""
    q, kp, kps, vp, vps, lane_map = _lane_inputs(k=k, t=t)
    lane_map = _lane_map_kind(kind, lane_map)
    xla = np.asarray(jatt.self_attention_int8_lanes_xla(
        q, kp, kps, vp, vps, lane_map, valid_len))
    qb, ksb, vsb = _bf16(q), _bf16(kps), _bf16(vps)
    pallas = np.asarray(jatt.self_attention_int8_lanes(
        jnp.asarray(qb, jnp.bfloat16), kp, jnp.asarray(ksb, jnp.bfloat16), vp,
        jnp.asarray(vsb, jnp.bfloat16), lane_map, valid_len, interpret=True), np.float32)
    for slice_t in sorted({tatt.lanes_plan(t)[1], -(-t // 2), -(-t // 3)}):
        got = lanes_mirror(*map(torch.from_numpy, (q, kp, kps, vp, vps, lane_map)),
                           valid_len, slice_t)
        np.testing.assert_allclose(got.numpy(), xla, atol=1e-5, rtol=1e-5)
        got_bf16 = lanes_mirror(*_to_torch_bf16(qb, kp, ksb, vp, vsb, lane_map),
                                valid_len, slice_t)
        assert got_bf16.dtype == torch.bfloat16
        np.testing.assert_allclose(got_bf16.float().numpy(), pallas, atol=2e-2, rtol=2e-2)


def test_self_int8_xla_prefill_matches_jax():
    """The quantized prefill's plain path, causal mask over Tq = 5 rows."""
    q, kq, ks, vq, vs = _self_inputs(seed=7, tq=5, t=8)
    mask = np.arange(8)[None, :] <= 3 + np.arange(5)[:, None]
    ref = np.asarray(jatt.self_attention_int8_xla(q, kq, ks, vq, vs, mask[None, None]))
    got = tatt.self_attention_int8_xla(
        *map(torch.from_numpy, (q, kq, ks, vq, vs)), torch.from_numpy(mask)[None, None])
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_quantize_kv_rows_bit_equal_to_jax():
    x = (np.random.default_rng(8).standard_normal((3, 7, 4 * 64)) * 2).astype(np.float32)
    x[0, 2] = 0.0                          # an all-zero row: the scale clamps at 1e-8
    xq_j, s_j = jwm._quantize_kv_rows(jnp.asarray(x), 4)
    xq_t, s_t = two.quantize_kv_rows(torch.from_numpy(x), 4)
    assert xq_t.shape == (3, 4, 7, 64) and xq_t.dtype == torch.int8
    assert s_t.dtype == torch.bfloat16
    np.testing.assert_array_equal(xq_t.numpy(), np.asarray(xq_j))
    np.testing.assert_array_equal(s_t.float().numpy(), np.asarray(s_j, np.float32))


def test_beam_lane_cache_bit_equal_to_jax():
    rng = np.random.default_rng(9)
    l, b, h, t, dh = 2, 2, 3, 6, 64
    cache = {"k_q": rng.integers(-127, 128, (l, b, h, t, dh)).astype(np.int8),
             "v_q": rng.integers(-127, 128, (l, b, h, t, dh)).astype(np.int8),
             "k_s": _bf16(rng.random((l, b, h, t))), "v_s": _bf16(rng.random((l, b, h, t)))}
    ref = jwm.beam_lane_cache(
        {key: jnp.asarray(x, jnp.bfloat16 if x.dtype == np.float32 else x.dtype)
         for key, x in cache.items()}, 3)
    got = twm.beam_lane_cache(dict(zip(cache, _to_torch_bf16(*cache.values()))), 3)
    assert got["k_p"].shape == (l, b, h * dh, 3, t) and got["v_p"].shape == (l, b, 3, t, h * dh)
    for key in ("k_p", "v_p", "k_ps", "v_ps"):
        assert got[key].dtype == (torch.int8 if key in ("k_p", "v_p") else torch.bfloat16)
        np.testing.assert_array_equal(got[key].float().numpy(),
                                      np.asarray(ref[key], np.float32))


def test_wrappers_run_plain_versions_on_cpu():
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 300, 64)).astype(np.float32))
               for _ in range(3))
    tatt.reset_launch_counts()
    torch.testing.assert_close(tatt.flash_attention(q, k, v),
                               tatt.flash_attention_reference(q, k, v), rtol=0, atol=0)
    qc, kv, t = _cross_inputs(2)
    args = [torch.from_numpy(x) for x in
            (qc, kv["k_q"], kv["v_q"], kv["k_scale"], kv["v_scale"])]
    torch.testing.assert_close(tatt.cross_attention_int8(*args, seq_len=t),
                               tatt.cross_attention_int8_reference(*args, seq_len=t),
                               rtol=0, atol=0)
    torch.testing.assert_close(tatt.cross_attention_s8(*args, seq_len=t),
                               tatt.cross_attention_s8_reference(*args, seq_len=t),
                               rtol=0, atol=0)
    args = [torch.from_numpy(x) for x in _self_inputs()]
    torch.testing.assert_close(tatt.self_attention_int8(*args, 11),
                               tatt.self_attention_int8_reference(*args, 11),
                               rtol=0, atol=0)
    args = [torch.from_numpy(x) for x in _lane_inputs()]
    torch.testing.assert_close(tatt.self_attention_int8_lanes(*args, 11),
                               tatt.self_attention_int8_lanes_reference(*args, 11),
                               rtol=0, atol=0)
    # the counts record kernel launches only
    assert tatt.launch_counts == {"flash_attention": 0, "cross_attention_int8": 0,
                                  "cross_attention_s8": 0, "self_attention_int8": 0,
                                  "self_attention_int8_lanes": 0}


@pytest.mark.parametrize("kernel", ["self_attention_int8", "self_attention_int8_lanes"])
def test_plain_versions_take_a_tensor_valid_len(kernel):
    """valid_len as the one-element int32 tensor the kernels read from
    device memory (the decoder's pos + 1 at a tensor pos): the plain
    versions and the CPU wrappers equal the int valid_len bit for bit."""
    args = [torch.from_numpy(x) for x in (_self_inputs() if kernel == "self_attention_int8"
                                          else _lane_inputs())]
    plain = getattr(tatt, f"{kernel}_reference")
    for valid_len in (1, 11, 16):
        at = torch.tensor([valid_len], dtype=torch.int32)
        ref = plain(*args, valid_len)
        assert torch.equal(plain(*args, at), ref)
        assert torch.equal(getattr(tatt, kernel)(*args, at), ref)
        assert torch.equal(plain(*args, at.view(())), ref)


@pytest.mark.parametrize("valid_len,error", [
    (0, "out of"), (17, "out of"), (torch.tensor([3]), "int32"),
    (torch.tensor([3, 4], dtype=torch.int32), "one int32")])
def test_device_valid_len_refuses_what_the_kernels_cannot_read(valid_len, error):
    """The wrappers' key count before a launch: a host int is range-checked
    against T and put on the device as int32; a tensor must already be one
    int32 on q's device (its value is never read on the host: the
    kernels clamp it to [1, T])."""
    with pytest.raises(ValueError, match=error):
        tatt._device_valid_len("k", valid_len, 16, torch.device("cpu"))
    got = tatt._device_valid_len("k", 16, 16, torch.device("cpu"))
    assert got.dtype == torch.int32 and got.tolist() == [16]
    at = torch.tensor([99], dtype=torch.int32)
    assert tatt._device_valid_len("k", at, 16, torch.device("cpu")) is at


def test_kernel_sources_export_their_entry_points():
    """Every kernel the wrappers launch has a source with its C entry
    point and error string, and opens with the note naming the TPU
    kernel it replaces (or, for the Llama layer's and the Whisper decoder
    step's kernels, the JAX code that XLA fuses; for the DeepSeek-V3
    path's, which the JAX package does not have, that it has no TPU
    counterpart and the port's model it serves)."""
    deepseek = {"int4_moe_s8", "int4_group_matmul", "mla_attention", "moe_route"}
    for name in build.SIGNATURES:
        src = pathlib.Path(build.source_path(name)).read_text()
        assert f'extern "C" int tww_{name}(' in src
        assert f'extern "C" const char* tww_{name}_error(int code)' in src
        head = src.split("#include")[0]
        if name in deepseek:
            assert "No TPU counterpart" in head and "models/deepseek_v3.py" in head
        else:
            assert any(where in head for where in (
                "turbo_whisper_workspace_tpu/ops/attention.py",
                "turbo_whisper_workspace_tpu/ops/quant.py", "scripts/profile_llm_ops.py",
                "turbo_whisper_workspace_tpu/models/llama.py",
                "turbo_whisper_workspace_tpu/models/whisper.py",
                "turbo_whisper_workspace_tpu/decode/rules.py"))
        assert "bound" in head and "Design" in head
    # the wrappers (ops/attention.py, ops/quant.py, ops/llama_ops.py,
    # ops/whisper_ops.py, ops/mla_ops.py, ops/moe_ops.py, the profiler's
    # two) pass as many arguments as the C signatures declare, and every
    # kernel has one
    from turbo_whisper_workspace_tpu_torch.ops import llama_ops as tllama
    from turbo_whisper_workspace_tpu_torch.ops import mla_ops as tmla
    from turbo_whisper_workspace_tpu_torch.ops import moe_ops as tmoe
    from turbo_whisper_workspace_tpu_torch.ops import quant as tquant
    from turbo_whisper_workspace_tpu_torch.ops import whisper_ops as twhisper
    from turbo_whisper_workspace_tpu_torch.scripts import profile_llm_ops as tprof

    calls = {}
    for module in (tatt, tquant, tllama, twhisper, tmla, tmoe, tprof):
        tree = ast.parse(pathlib.Path(module.__file__).read_text())
        calls.update({c.args[0].value: len(c.args) - 1 for c in ast.walk(tree)
                      if isinstance(c, ast.Call) and getattr(c.func, "attr", "") == "launch"})
    assert calls == {n: len(s) for n, s in build.SIGNATURES.items()}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs these checks on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("tq", [1, 4, 5])
def test_cuda_kernels_match_plain_versions(cuda_device, tq):
    gen = torch.Generator(cuda_device).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=cuda_device)

    q, k, v = (randn(2, 3, 300, 64).to(torch.bfloat16) for _ in range(3))
    out = tatt.flash_attention(q, k, v)
    torch.testing.assert_close(out.float(), tatt.flash_attention_reference(q, k, v).float(),
                               atol=2e-2, rtol=2e-2)
    # the encoder's layout: (B, H, T, 64) views of (B, T, H·64) projections;
    # T = 1500 (the encoder's: a ragged last key tile of 28) and 129 (one
    # key past two tiles, a query tile of one row)
    for t in (300, 1500, 129):
        q, k, v = (randn(2, t, 3 * 64).to(torch.bfloat16).view(2, t, 3, 64).transpose(1, 2)
                   for _ in range(3))
        out = tatt.flash_attention(q, k, v)
        assert out.stride() == q.stride()
        ref = tatt.flash_attention_reference(q, k, v).float()
        torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=2e-2)
        assert (out.float() - ref).norm() <= 5e-3 * ref.norm()
    kv = tatt.quantize_cross_kv_int8(randn(1, 2, 4, 1500, 64), randn(1, 2, 4, 1500, 64))
    args = (randn(2, 4, tq, 64).to(torch.bfloat16), kv["k_q"][0], kv["v_q"][0],
            kv["k_scale"][0], kv["v_scale"][0])
    torch.testing.assert_close(
        tatt.cross_attention_int8(*args, seq_len=1500).float(),
        tatt.cross_attention_int8_reference(*args, seq_len=1500).float(),
        atol=2e-2, rtol=2e-2)
    # int8 self-KV cache at Tq query rows, and the lane cache at K = tq beams
    kq, ks = two.quantize_kv_rows(randn(6, 40, 4 * 64), 4)
    vq, vs = two.quantize_kv_rows(randn(6, 40, 4 * 64), 4)
    args = (randn(6, 4, tq, 64).to(torch.bfloat16), kq, ks, vq, vs)
    for valid_len in (1, 23, 40):
        torch.testing.assert_close(
            tatt.self_attention_int8(*args, valid_len).float(),
            tatt.self_attention_int8_reference(*args, valid_len).float(),
            atol=2e-2, rtol=2e-2)
    b, h, t = 2, 4, 40
    kq, ks = two.quantize_kv_rows(randn(b, tq * t, h * 64), h)   # (B, H, K·T, 64)
    vq, vs = two.quantize_kv_rows(randn(b, tq * t, h * 64), h)
    lane_map = torch.randint(0, tq, (b, tq, t), generator=gen, device=cuda_device,
                             dtype=torch.int32)
    lane_map[:, :, :3] = 0
    args = (randn(b, h, tq, 64).to(torch.bfloat16),
            kq.permute(0, 1, 3, 2).reshape(b, h * 64, tq * t).contiguous(), ks,
            vq.permute(0, 2, 1, 3).reshape(b, tq * t, h * 64).contiguous(), vs, lane_map)
    for valid_len in (1, 23, 40):
        torch.testing.assert_close(
            tatt.self_attention_int8_lanes(*args, valid_len).float(),
            tatt.self_attention_int8_lanes_reference(*args, valid_len).float(),
            atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("t,valid_len,tq,misaligned", [
    (227, 1, 1, False), (227, 115, 1, False), (227, 227, 1, False), (448, 448, 1, False),
    (227, 115, 2, False), (229, 101, 1, True), (229, 229, 3, True)])
def test_cuda_self_attention_int8_bulk_copies(cuda_device, t, valid_len, tq, misaligned):
    """The redesigned self_attention_int8 at the beam path's B·K = 40,
    H = 20: K and V slabs as bulk copies, scale rows at every offset
    modulo 16 (T = 229: rows 458 bytes apart; `misaligned`: the scale
    tensors themselves start 2 bytes past a boundary), Whisper's whole
    448-position context (two waves of blocks) and Tq > 1. Within 2e-2
    max abs and 5e-3 relative L2 of the plain version; the keys past
    valid_len, dropped from the mask, read above it."""
    gen = torch.Generator(cuda_device).manual_seed(t + valid_len)
    kq, ks = two.quantize_kv_rows(torch.randn(40, t, 20 * 64, generator=gen,
                                               device=cuda_device), 20)
    vq, vs = two.quantize_kv_rows(torch.randn(40, t, 20 * 64, generator=gen,
                                               device=cuda_device), 20)
    if misaligned:
        def shift(x):
            flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
            flat[1:] = x.reshape(-1)
            return flat[1:].view(x.shape)
        ks, vs = shift(ks), shift(vs)
        assert ks.data_ptr() % 16 and vs.data_ptr() % 16
    q = torch.randn(40, 20, tq, 64, generator=gen, device=cuda_device).to(torch.bfloat16)
    got = tatt.self_attention_int8(q, kq, ks, vq, vs, valid_len).float()
    torch.cuda.synchronize()
    ref = tatt.self_attention_int8_reference(q, kq, ks, vq, vs, valid_len).float()
    assert (got - ref).abs().max() <= 2e-2
    assert (got - ref).norm() <= 5e-3 * ref.norm()
    if valid_len < t:
        unmasked = tatt.self_attention_int8_reference(q, kq, ks, vq, vs, t).float()
        assert (unmasked - ref).norm() > 5e-3 * ref.norm()


@pytest.mark.cuda
@pytest.mark.parametrize("tq", [1, 4, 5, 35])
@pytest.mark.parametrize("t,seq_len", [(1500, 1500), (1500, 100), (300, 300), (200, 100)])
def test_cuda_cross_cluster_matches_plain_version(cuda_device, tq, t, seq_len):
    """cross_attention_int8 at C > 1 ranks (Tpad 1536: 8; 384: 3; 256:
    2), query rows in chunks (Tq 35: five chunks of 8), and slices wholly
    past seq_len (100)."""
    gen = torch.Generator(cuda_device).manual_seed(tq)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=cuda_device)

    kv = tatt.quantize_cross_kv_int8(randn(1, 2, 4, t, 64), randn(1, 2, 4, t, 64))
    args = (randn(2, 4, tq, 64).to(torch.bfloat16), kv["k_q"][0], kv["v_q"][0],
            kv["k_scale"][0], kv["v_scale"][0])
    assert tatt.cross_int8_plan(tq, kv["k_q"].shape[-1])[0] > 1
    out = tatt.cross_attention_int8(*args, seq_len=seq_len).float()
    ref = tatt.cross_attention_int8_reference(*args, seq_len=seq_len).float()
    torch.testing.assert_close(out, ref, atol=2e-2, rtol=2e-2)
    assert (out - ref).norm() <= 5e-3 * ref.norm()


def _ancestry(gen, b, k, t, dev, prompt=3):
    """lane_map (B, K, T) of a beam search from a `prompt`-token prompt in
    lane 0: at each step every beam continues a random beam and writes
    its own lane (chip_smoke.py's random_ancestry)."""
    lane_map = torch.zeros((b, k, t), dtype=torch.int32, device=dev)
    own = torch.arange(k, dtype=torch.int32, device=dev).expand(b, k)
    for pos in range(prompt, t):
        src = torch.randint(0, k, (b, k), generator=gen, device=dev)
        lane_map = lane_map.gather(1, src[:, :, None].expand(b, k, t))
        lane_map[:, :, pos] = own
    return lane_map


@pytest.mark.cuda
@pytest.mark.parametrize("k,t", [(5, 227), (8, 448)])
@pytest.mark.parametrize("valid_len", [1, 3, 115, None])
def test_cuda_lanes_cluster_matches_plain_version(cuda_device, k, t, valid_len):
    """self_attention_int8_lanes on its cluster (8 ranks at T = 227 and
    448: at valid_len 1, 3 (the prompt: lane 0 alone) and 115 the ranks
    past it own nothing) over a beam ancestry, K·T odd at T = 227, K = 8
    at T = 448."""
    valid_len = t if valid_len is None else valid_len
    gen = torch.Generator(cuda_device).manual_seed(k)
    b, h = 2, 4
    kq, ks = two.quantize_kv_rows(torch.randn(b, k * t, h * 64, generator=gen,
                                               device=cuda_device), h)
    vq, vs = two.quantize_kv_rows(torch.randn(b, k * t, h * 64, generator=gen,
                                               device=cuda_device), h)
    args = (torch.randn(b, h, k, 64, generator=gen, device=cuda_device).to(torch.bfloat16),
            kq.permute(0, 1, 3, 2).reshape(b, h * 64, k * t).contiguous(), ks,
            vq.permute(0, 2, 1, 3).reshape(b, k * t, h * 64).contiguous(), vs,
            _ancestry(gen, b, k, t, cuda_device))
    out = tatt.self_attention_int8_lanes(*args, valid_len).float()
    ref = tatt.self_attention_int8_lanes_reference(*args, valid_len).float()
    assert (out - ref).abs().max().item() <= 2e-2
    assert (out - ref).norm() <= 5e-3 * ref.norm()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["self_attention_int8", "self_attention_int8_lanes"])
def test_cuda_graph_replay_reads_valid_len_from_device_memory(cuda_device, kernel):
    """One launch captured in a CUDA graph at valid_len 115 over the beam
    path's T = 227, then 227 written into the device scalar and the graph
    replayed: the output is the plain version's at 227 (the launch is
    sized by T alone; the kernel reads the key count when it runs)."""
    gen = torch.Generator(cuda_device).manual_seed(3)
    t, h = 227, 4
    if kernel == "self_attention_int8":
        kq, ks = two.quantize_kv_rows(torch.randn(10, t, h * 64, generator=gen,
                                                   device=cuda_device), h)
        vq, vs = two.quantize_kv_rows(torch.randn(10, t, h * 64, generator=gen,
                                                   device=cuda_device), h)
        args = (torch.randn(10, h, 1, 64, generator=gen, device=cuda_device).to(torch.bfloat16),
                kq, ks, vq, vs)
    else:
        b, k = 2, 5
        kq, ks = two.quantize_kv_rows(torch.randn(b, k * t, h * 64, generator=gen,
                                                   device=cuda_device), h)
        vq, vs = two.quantize_kv_rows(torch.randn(b, k * t, h * 64, generator=gen,
                                                   device=cuda_device), h)
        args = (torch.randn(b, h, k, 64, generator=gen, device=cuda_device).to(torch.bfloat16),
                kq.permute(0, 1, 3, 2).reshape(b, h * 64, k * t).contiguous(), ks,
                vq.permute(0, 2, 1, 3).reshape(b, k * t, h * 64).contiguous(), vs,
                _ancestry(gen, b, k, t, cuda_device))
    fn, plain = getattr(tatt, kernel), getattr(tatt, f"{kernel}_reference")
    valid_len = torch.tensor([115], dtype=torch.int32, device=cuda_device)
    fn(*args, valid_len)                  # the attribute and the library, before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*args, valid_len)
    graph.replay()
    torch.cuda.synchronize()
    for n in (115, 227):
        valid_len.fill_(n)
        graph.replay()
        torch.cuda.synchronize()
        ref = plain(*args, n).float()
        assert (out.float() - ref).abs().max().item() <= 2e-2, n
        assert (out.float() - ref).norm() <= 5e-3 * ref.norm(), n
