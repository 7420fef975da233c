"""A whole run on the CPU (the look for a card skipped) at tiny size: a
sound run is correct, and each fault the cells can have, planted in the
timed path, makes `correct` come out false. The cells run on one card, so
no exchange between cards can be left out."""

import json

import pytest
import torch

from port_bench.lib import bench, spec
from port_bench.tests import tiny

LIMITS = {name: spec.cell(name)["limits"] for name in tiny.CELLS}


def run(tmp_path, capsys, cell: str, seed: int = 2**31 + 3, tracing: bool = False) -> dict:
    root = tiny.make_root(str(tmp_path), LIMITS)
    # every row of every call is compared, so a fault in any row shows
    with open(f"{root}/cells/{cell}.json") as f:
        params = json.load(f)
    if "check_rows" in params:
        params.update(check_calls=8, check_rows=8)
    with open(f"{root}/cells/{cell}.json", "w") as f:
        json.dump(params, f)
    rc = bench.run_cell(root, cell, seed, 0.0, tracing, 0.0, device="cpu", data_dir=root)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def plant_whisper_token(monkeypatch):
    """A token altered where it is produced: the sampled token + 1."""
    from turbo_whisper_workspace_tpu_torch.ops import whisper_ops

    rules = whisper_ops.whisper_logit_rules

    def altered(*args, **kw):
        tok, logp, cand = rules(*args, **kw)
        return (tok + 1) % args[0].shape[-1], logp, cand

    monkeypatch.setattr(whisper_ops, "whisper_logit_rules", altered)


def plant_whisper_second_best(monkeypatch):
    """A wrong argmax: at temperature 0, the second-best token under the
    rules (where they allow one), reported with its own log-probability."""
    from turbo_whisper_workspace_tpu_torch.decode.rules import NEG_INF
    from turbo_whisper_workspace_tpu_torch.ops import whisper_ops

    rules_fn = whisper_ops.whisper_logit_rules

    def second(logits, rules, is_begin, last_tok, penult_tok, ts_floor, static_mask,
               begin_mask, noise=None, temperature=0.0, add=None):
        if noise is not None or add is not None:
            return rules_fn(logits, rules, is_begin, last_tok, penult_tok, ts_floor,
                            static_mask, begin_mask, noise, temperature, add)
        masked = rules.apply(logits, is_begin, last_tok, penult_tok, ts_floor, static_mask,
                             begin_mask)
        top = masked.topk(2, dim=-1)
        # the best where the rules allow no other token
        tok = torch.where(top.values[:, 1] > NEG_INF / 2, top.indices[:, 1], top.indices[:, 0])
        return tok, torch.log_softmax(masked, -1).gather(-1, tok[:, None])[:, 0], None

    monkeypatch.setattr(whisper_ops, "whisper_logit_rules", second)


def plant_whisper_frozen_step(monkeypatch):
    """A step that returns its state unchanged."""
    from turbo_whisper_workspace_tpu_torch.decode import greedy

    monkeypatch.setattr(greedy, "run_steps", lambda step, state, n, *a, **k: n)


def plant_whisper_half_batch(monkeypatch):
    """Half of the batch left out: only the first half's rows decoded, the
    rest keep the state the loop starts from (the prompt, then EOT)."""
    from turbo_whisper_workspace_tpu_torch.decode import greedy

    decode = greedy.greedy_decode_features

    def half(model, cross_kv, prompt, **kw):
        b = prompt.shape[0]
        if b < 2:
            return decode(model, cross_kv, prompt, **kw)
        keep = {k: v[:, : b // 2] for k, v in cross_kv.items()}
        res = decode(model, keep, prompt[: b // 2], **kw)
        rest = b - b // 2
        left = (prompt[b // 2:].new_full((rest, res.tokens.shape[1]), kw["rules"].specials.eot),
                res.lengths.new_zeros(rest), *(x.new_zeros(rest) for x in res[2:]))
        left[0][:, : prompt.shape[1]] = prompt[b // 2:]
        return type(res)(*(torch.cat([x, y]) for x, y in zip(res, left)))

    monkeypatch.setattr(greedy, "greedy_decode_features", half)


def plant_llm_token(monkeypatch):
    from turbo_whisper_workspace_tpu_torch.llm import generate

    sample = generate.sample
    monkeypatch.setattr(generate, "sample", lambda logits, t, g: (sample(logits, t, g) + 1)
                        % logits.shape[-1])


def plant_llm_frozen_step(monkeypatch):
    from turbo_whisper_workspace_tpu_torch.llm import generate

    monkeypatch.setattr(generate, "run_steps", lambda step, state, n, *a, **k: n)


@pytest.mark.parametrize("cell", ["turbo-batch-greedy", "turbo-requests", "mistral7b-enrich"])
def test_a_sound_run_is_correct(tmp_path, capsys, cell):
    out = run(tmp_path, capsys, cell)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    for name in ("correct", "attempted", "failed", "metrics", "device"):
        assert name in out
    for number in out["checks"].values():
        assert number["value"] <= number["limit"]


@pytest.mark.parametrize("cell", ["turbo-batch-greedy", "mistral7b-enrich"])
def test_a_traced_run_is_correct_and_leaves_the_port_unwrapped(tmp_path, capsys, cell):
    import importlib

    kernels = [spec.metric(m["name"]).KERNEL for m in spec.Spec(tiny.ROOT).data["per_layer"]
               if m["name"].endswith("_roofline")]
    before = [getattr(importlib.import_module(k["module"]), k["wrapper"]) for k in kernels]
    out = run(tmp_path, capsys, cell, tracing=True)
    assert out["correct"] is True
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert out["metrics"] and all(not n.endswith("_roofline") for n in out["metrics"])
    after = [getattr(importlib.import_module(k["module"]), k["wrapper"]) for k in kernels]
    assert after == before


@pytest.mark.parametrize("cell,plant", [
    ("turbo-batch-greedy", plant_whisper_token),
    ("turbo-batch-greedy", plant_whisper_frozen_step),
    ("turbo-batch-greedy", plant_whisper_half_batch),
    ("turbo-batch-greedy", plant_whisper_second_best),
    ("turbo-requests", plant_whisper_second_best),
    ("turbo-requests", plant_whisper_token),
    ("turbo-requests", plant_whisper_frozen_step),
    ("mistral7b-enrich", plant_llm_token),
    ("mistral7b-enrich", plant_llm_frozen_step),
], ids=lambda x: getattr(x, "__name__", x))
def test_a_planted_fault_is_not_correct(tmp_path, capsys, monkeypatch, cell, plant):
    plant(monkeypatch)
    out = run(tmp_path, capsys, cell)
    assert out["correct"] is False
    if plant is plant_whisper_second_best:
        # the number that catches a wrong argmax reported with its own log-probability
        assert out["checks"]["token_gap"]["value"] > out["checks"]["token_gap"]["limit"]
