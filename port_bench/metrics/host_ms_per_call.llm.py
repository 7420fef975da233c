"""The enrichment stage's host time a conversation: the wall of the
port's `llm.stage` spans less their `llm.generate` children (the prompt's
building and tokenizing, the reply's parsing) over the traced
conversations."""

from port_bench.lib import spans


def read(run):
    traced = spans.traced(run)
    if not run.traced or not spans.named(traced, "llm.stage"):
        return None
    return spans.self_ms(traced, "llm.stage", ("llm.generate",)) / len(run.traced)
