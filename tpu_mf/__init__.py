"""tpu-mf: a matrix-factorization training framework in JAX.

Built with the full capability set of the
reference CPU trainer ``cjolivier01/experimental-mf`` (TBB Hogwild SGD /
DP-SGLD / adaptive-regularization MF over protobuf rating blocks):

* biased rank-k MF trained by mini-batch synchronous SGD (replaces the
  reference's lock-free Hogwild inner loop, reference: src/mf.h:72-133),
* differentially-private Stochastic Gradient Langevin Dynamics with exact
  per-row lazy noise accounting, inverse-frequency regularization weights and
  Gibbs-sampled Gamma hyperpriors (reference: src/dpmf.h, src/model.cc:197-352),
* adaptive regularization via online hypergradient steps on the lambda
  scalars (Rendle's method; reference: src/admf.h, src/model.h:74-118),
* streaming data ingest, RMSE evaluation, checkpointing/warm-start, CLI.

The compute path is plain jax.numpy/lax compiled by XLA (NVIDIA GPUs, or the
CPU in tests); for MF, factor tables shard over a ``jax.sharding.Mesh`` and
scale via diagonal-block (Jellyfish-style) DSGD with ppermute collectives.
"""

__version__ = "0.1.0"

from tpu_mf.config import TrainConfig  # noqa: F401
