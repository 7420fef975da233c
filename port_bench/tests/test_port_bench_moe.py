"""The Moonlight cell's harness on the CPU at a tiny DeepSeek-V3 size: the
benchmark's reference against tests/ref_deepseek_v3.py, the draw
reproducible from the seed, a whole run correct and each planted fault
(an altered token, a wrong argmax, a frozen step) not, and the cell's
new metrics reading None, not 0, where a run has nothing to read."""

import json
import os

import pytest
import torch

from port_bench.lib import bench, costs, spec
from port_bench.lib import deepseek_v3 as dv3
from port_bench.reference import deepseek_v3 as ref
from port_bench.tests import tiny

# tests/ref_deepseek_v3.py by path: another package named `tests` on the
# path must not shadow it
plain = spec.load_module(os.path.join(tiny.ROOT, "tests", "ref_deepseek_v3.py"),
                         "ref_deepseek_v3")

CELL = "moonlight-enrich"
SEED = 2**31 + 5
# the published layout at 3 layers and narrow widths that keep the Q4
# point's groups: 128 over d = 256, 64 over the experts' 128 inputs
TINY = {**spec.load_json(f"{spec.BENCH_DIR}/configs/moonlight-16b-a3b-q4.json"),
        "vocab_size": 512, "hidden_size": 256, "num_hidden_layers": 3,
        "num_attention_heads": 4, "num_key_value_heads": 4, "kv_lora_rank": 64,
        "qk_nope_head_dim": 32, "qk_rope_head_dim": 16, "v_head_dim": 64,
        "intermediate_size": 512, "moe_intermediate_size": 128, "n_routed_experts": 8,
        "n_shared_experts": 1, "num_experts_per_tok": 2}
METRICS = ("int4_moe_s8_roofline", "mla_attention_roofline", "int4_group_matmul_roofline",
           "moe_route_roofline", "moe_launches_per_step.moe", "prefill_expert_share.moe",
           "expert_load_max_over_mean.moe")


def make_root(path: str) -> str:
    root = tiny.make_root(path)
    with open(os.path.join(root, "configs", "moonlight-16b-a3b-q4.json"), "w") as f:
        json.dump(TINY, f)
    mix = spec.traffic("enrich-20seg-moe")
    mix.update(pool_calls=3, greedy_every=1)
    mix["llm"].update(max_tokens_names=4, max_tokens_summary=5, max_tokens_topics=5)
    with open(os.path.join(root, "traffic", "enrich-20seg-moe.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(root, "cells", f"{CELL}.json"), "w") as f:
        json.dump(spec.cell(CELL), f)
    return root


def run(tmp_path, capsys, tracing=False) -> tuple[dict, dict]:
    root = make_root(str(tmp_path))
    assert bench.run_cell(root, CELL, SEED, 0.0, tracing, 0.0, device="cpu", data_dir=root) == 0
    out, err = capsys.readouterr()
    record = next(json.loads(line) for line in err.splitlines() if line.startswith('{"calls"'))
    return json.loads(out.strip().splitlines()[-1]), record


def test_the_benchmarks_reference_is_the_plain_reference_on_the_same_weights():
    """The prompt's rows keep their activations, so the last prompt row's
    logits are tests/ref_deepseek_v3.py's on the weights dequantized at
    the configuration's Q4 point."""
    q = TINY["quantization"]
    sd = {}
    for i in range(TINY["num_hidden_layers"]):
        for name, w in dv3.layer(TINY, SEED, i, "cpu").items():
            if w.dim() == 2 and "kv_b_proj" not in name and "mlp.gate.weight" not in name:
                g = q["expert_down_group"] if "experts" in name and "down" in name else q["group"]
                w = ref.quantize_weight(w, q["body_bits"], g)
            sd[name] = w
    ends = dv3.ends(TINY, SEED, "cpu")
    sd["model.embed_tokens.weight"] = ends["model.embed_tokens.weight"]
    sd["lm_head.weight"] = ref.quantize_weight(ends["lm_head.weight"], q["head_bits"], None)
    sd["model.norm.weight"] = torch.ones(TINY["hidden_size"])
    seqs = [(list(range(40, 70)), 30), (list(range(7, 52)), 45)]
    got, routes = ref.served_logits(TINY, SEED, seqs, "cpu", routes=True)
    for (toks, p), logits, chosen in zip(seqs, got, routes):
        want = plain.forward(sd, TINY, torch.tensor(toks))
        torch.testing.assert_close(logits, want[p - 1:], rtol=1e-4, atol=1e-4 * want.abs().max())
        want_routes = plain.routing(sd, TINY, torch.tensor(toks))
        assert [c.tolist() for c in chosen] == [r[p - 1:].tolist() for r in want_routes]


def test_the_draw_is_reproducible_from_the_seed():
    a, b = dv3.layer(TINY, SEED, 1, "cpu"), dv3.layer(TINY, SEED, 1, "cpu")
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    other = dv3.layer(TINY, SEED + 1, 1, "cpu")
    assert not torch.equal(a["model.layers.1.mlp.experts.3.up_proj.weight"],
                           other["model.layers.1.mlp.experts.3.up_proj.weight"])
    bias = a["model.layers.1.mlp.gate.e_score_correction_bias"]
    assert bias.dtype == torch.float32 and 0.005 < bias.std().item() < 0.02
    assert torch.equal(dv3.ends(TINY, SEED, "cpu")["lm_head.weight"],
                       dv3.ends(TINY, SEED, "cpu")["lm_head.weight"])


def test_the_flops_count_the_active_parameters():
    per_token = dv3.token_flops(spec.load_json(
        f"{spec.BENCH_DIR}/configs/moonlight-16b-a3b-q4.json"), 0) / 2
    assert 2.1e9 < per_token < 2.4e9              # ~2.2 B active body parameters


def test_a_sound_run_is_correct(tmp_path, capsys):
    out, record = run(tmp_path, capsys)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    check = record["checks"][0]
    assert check["value"] <= check["limit"] and 0.0 <= check["routing_differs"] <= 1.0
    assert "routing_differs" not in out["checks"]["mean_gap"]


def plant_token(monkeypatch):
    from turbo_whisper_workspace_tpu_torch.llm import generate

    sample = generate.sample
    monkeypatch.setattr(generate, "sample",
                        lambda logits, t, g: (sample(logits, t, g) + 1) % logits.shape[-1])


def plant_second_best(monkeypatch):
    from turbo_whisper_workspace_tpu_torch.llm import generate

    monkeypatch.setattr(generate, "sample", lambda logits, t, g: logits.topk(2, -1).indices[:, 1])


def plant_frozen_step(monkeypatch):
    from turbo_whisper_workspace_tpu_torch.llm import generate

    monkeypatch.setattr(generate, "run_steps", lambda step, state, n, *a, **k: n)


@pytest.mark.parametrize("plant", [plant_token, plant_second_best, plant_frozen_step],
                         ids=lambda f: f.__name__)
def test_a_planted_fault_is_not_correct(tmp_path, capsys, monkeypatch, plant):
    plant(monkeypatch)
    out, _ = run(tmp_path, capsys)
    assert out["correct"] is False


def test_the_new_metrics_read_none_with_nothing_to_read_and_numbers_in_a_traced_run(
        tmp_path, capsys):
    empty = bench.Run(workload=CELL, config=TINY, entry=None, setup_s=0.0, window_start=0.0,
                      calls=[])
    for name in METRICS:
        assert spec.metric(name).read(empty) is None, name
    out, _ = run(tmp_path, capsys, tracing=True)
    assert out["correct"] is True
    got = out["metrics"]
    # the CPU has no device trace: the rooflines read nothing
    assert not [name for name in got if name.endswith("_roofline")]
    # 2 expert layers, 2 launches each a step (and the capture's warm-up: none, eager)
    assert got["moe_launches_per_step.moe"]["value"] == 4.0
    assert 0.0 < got["prefill_expert_share.moe"]["value"] < 100.0
    assert got["expert_load_max_over_mean.moe"]["value"] >= 1.0


def test_the_roofline_costs_count_a_launchs_bytes():
    from port_bench.lib import spec as s

    moe = s.metric("int4_moe_s8_roofline")
    xq, xs = torch.zeros(1, 2048, dtype=torch.int8), torch.zeros(1, 16)
    w, sc = torch.zeros(66, 1024, 2816, dtype=torch.int8), torch.zeros(66, 16, 2816)
    ops, nbytes, bound = moe.cost(xq, xs, w, sc, torch.zeros(8, dtype=torch.int64), x_div=8)
    assert nbytes > 8 * 1024 * 2816 and ops == 2.0 * 8 * 2048 * 2816
    assert bound == nbytes / costs.PEAK_HBM_BYTES_S
    mla = s.metric("mla_attention_roofline")
    q_lat = torch.zeros(1, 1, 16, 512)
    cache = torch.zeros(1, 2000, 576)
    ops, nbytes, bound = mla.cost(q_lat, torch.zeros(1, 1, 16, 64), torch.zeros(1, 1, 512),
                                  torch.zeros(1, 1, 64), None, None, cache, 0, 0.07)
    assert 2 * 2000 * 576 < nbytes < 2 * 2100 * 576 and bound == nbytes / costs.PEAK_HBM_BYTES_S
    group = s.metric("int4_group_matmul_roofline")
    ops, nbytes, bound = group.cost(torch.zeros(100, 2048), w, sc, [60, 0] + [40] + [0] * 63)
    assert ops == 2.0 * 100 * 2048 * 2816 and nbytes > 2 * 1024 * 2816
    assert bound == max(ops / costs.PEAK_BF16_FLOPS, nbytes / costs.PEAK_HBM_BYTES_S)
    route = s.metric("moe_route_roofline")
    ops, nbytes, bound = route.cost(torch.zeros(1, 2048), torch.zeros(64, 2048), torch.zeros(64),
                                    torch.zeros(2), 6, 2.446)
    assert 2 * 64 * 2048 < nbytes < 2 * 64 * 2048 + 10000
    assert bound == nbytes / costs.PEAK_HBM_BYTES_S
