"""rattle_tpu_torch: the PyTorch/CUDA port of rattle_tpu for one NVIDIA H100.

The clustering path (``cluster``, ``cluster --iso``, ``cluster_summary``,
``extract_clusters``) runs on the card through two hand-written CUDA kernels
(``csrc/bv_common.cu``, ``csrc/lis_filter.cu``), ``correct`` and ``polish``
through a third (``csrc/poa_align.cu``).  Several processes, one device
each, run ``cluster`` as one gloo group (``parallel/launch.py``).
Framework-free modules are
copies of their ``rattle_tpu`` counterparts; nothing here imports JAX or
``rattle_tpu``.
"""

__version__ = "0.1.0"
