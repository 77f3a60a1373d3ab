"""rattle_tpu_torch: the PyTorch/CUDA port of rattle_tpu for one NVIDIA H100.

The clustering path (``cluster``, ``cluster --iso``, ``cluster_summary``,
``extract_clusters``) runs on the card through two hand-written CUDA kernels
(``csrc/bv_common.cu``, ``csrc/lis_filter.cu``).  Framework-free modules are
copies of their ``rattle_tpu`` counterparts; nothing here imports JAX or
``rattle_tpu``.
"""

__version__ = "0.1.0"
