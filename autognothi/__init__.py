"""AutoGnothi in JAX: a framework for faithful self-interpretability in
black-box transformers, run on NVIDIA GPUs.

Re-implements the full capability surface of the reference implementation of
"Gnothi Seauton: Empowering Faithful Self-Interpretability in Black-Box
Transformers" (ICLR 2025) — side-network Shapley explainers trained onto
frozen BERT/ViT classifiers — redesigned for compiled accelerators:

- functional models over parameter pytrees (no mutable modules),
- the coalition dimension (batch x n_mask_samples masked forwards) batched,
  vmapped and sharded over a `jax.sharding.Mesh`,
- a Pallas/Triton kernel for the coalition-masked attention hot path,
- optax optimizer partitioning instead of `.requires_grad` freezing,
- orbax/npz checkpoints with the reference's epoch/cadence semantics.
"""

__version__ = "0.1.0"

RECIPE_VERSION = "beta.1.01"
