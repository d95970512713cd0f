"""cuking_tpu — a KING relatedness engine in JAX for GPUs.

A from-scratch JAX/XLA framework with the capabilities of
populationgenomics/cuKING (reference: cuking.cu): it ingests
sparse ``(row_idx, col_idx, n_alt_alleles)`` Parquet tables exported from a
Hail MatrixTable, packs genotypes into per-sample 2-bit-plane bitsets, computes
IBS0/IBS1/IBS2 and Hail's between-family KING kinship coefficient for every
sample pair, and writes kin-thresholded results as sorted Snappy Parquet
partitions — bit-identical to the reference and to ``hl.king``.

Unlike the reference's one-CUDA-block-per-pair popcount kernel, the compute
path reformulates all six KING counters as int8 inner products of per-site
{het, hom-alt, defined} indicator planes, so the hot loop is an int8 matrix
product with int32 sums on the tensor cores.  Multi-device scaling uses a
``jax.sharding.Mesh`` + ``shard_map`` ring exchange of sample panels (NCCL
over NVLink) instead of the reference's share-nothing GCS sharding (which is
also kept, as ``--split_factor`` / ``--shard_index``, for process-level
fan-out parity).
"""

__version__ = "0.1.0"

from cuking_tpu.api import king  # noqa: F401
from cuking_tpu.prune import related_samples_to_drop  # noqa: F401
from cuking_tpu.models.king import KingConfig, KingEngine, ResultSet  # noqa: F401
from cuking_tpu.ops.king_math import KingCounts, KingResult  # noqa: F401
from cuking_tpu.parallel.submatrix import Submatrix  # noqa: F401
