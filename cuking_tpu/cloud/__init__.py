"""Cloud orchestration: shard fan-out over independent GPU Batch tasks.

The reference's L5 layer (SURVEY.md §1): cloud_batch_submit.py renders a GCP
Cloud Batch job of k(k+1)/2 share-nothing GPU tasks.  A multi-GPU host can
process the whole matrix in one job (cuking_tpu.parallel.ring), but the
fan-out path is kept for memory-bound cohorts and for single-GPU parity
with the reference deployment model.
"""
