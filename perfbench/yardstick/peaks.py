"""The chip's peaks, frozen for the benchmark.

Copied from ``src/repro_torch/obs/profile.py:42-44`` (``HBM_BW``,
``PEAK_FLOPS``) and ``chip_smoke.py:272-274`` (the same rates under other
names).  NVIDIA H100 SXM5 80GB HBM3 at its 700 W limit, NVIDIA's data
sheet, dense rates without sparsity.  A card set below 700 W
(``nvidia-smi --query-gpu=power.limit``) runs below these peaks; the
harness reports the limit beside every share.
"""

HBM_BW = 3.35e12                    # bytes/s
PEAK_FLOPS = {"float32": 67e12,     # outside the tensor cores, no TF32
              "float64": 34e12,
              "bfloat16": 989e12, "float16": 989e12}
