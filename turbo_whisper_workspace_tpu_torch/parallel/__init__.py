"""Data- and tensor-parallel execution over torch.distributed ranks.

Port of turbo_whisper_workspace_tpu/parallel/: device meshes (`mesh`),
Megatron-style parameter sharding (`sharding`), DP and TP decode
(`infer`), the training step (`train`) and the multi-host directory
driver (`batch_driver`). Where the JAX package shards arrays over one
program's devices, here each rank is a process holding its own rows of
the batch and its own shard of the model, and the collectives are
explicit calls, counted by `mesh.collective_counts`.
"""
