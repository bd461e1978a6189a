"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

* :mod:`.ops` — the public wrappers (check, then dispatch by device).
* :mod:`.ref` — the plain versions (the CPU path and the kernels' oracle).
* :mod:`.fused_dots`, :mod:`.fused_axpy`, :mod:`.spmv_ell`,
  :mod:`.precond_apply`, :mod:`.flash_attention`, :mod:`.grouped_mm` — the
  launchers of ``src/repro_torch/csrc/*.cu`` (:mod:`.grouped_mm` holds its
  plain version too).
* :mod:`._build` — the ``nvcc`` build, the ``ctypes`` binding and the
  launch counters.
"""
