"""How unevenly the prefills route: from the port's program counter
`moe.routed_tokens` (the prompt rows routed to each (layer, routed
expert) while the profiler recorded, a device buffer), each expert
layer's busiest expert over its mean, averaged over the layers. 1 is an
even load; the prefill's one-matmul-per-expert loop waits on the
busiest."""


def read(run):
    from turbo_whisper_workspace_tpu_torch.utils import profiling

    if run.trace is None or not hasattr(profiling, "counters"):
        return None
    counts = profiling.counters().get("moe.routed_tokens")
    if counts is None:
        return None
    counts = counts.double()
    layers = counts[counts.sum(-1) > 0]
    if not len(layers):
        return None
    return (layers.amax(-1) / layers.mean(-1)).mean().item()
