"""Device inventory dump — the `caffe device_query` analog
(caffe/tools/caffe.cpp device_query brew), on ``torch.cuda``: each CUDA
card's name, compute capability, SM count, and free and total memory. A
query, not an entry point that runs on the card: without one it says so
and exits 0.

Usage: python -m smallhardface_tpu_torch.tools.device_query
"""

from __future__ import annotations

import torch


def main():
    print(f"torch: {torch.__version__} (CUDA {torch.version.cuda})")
    if not torch.cuda.is_available():
        print("no CUDA device (torch.cuda.is_available() is false)")
        return 0
    print(f"CUDA devices: {torch.cuda.device_count()}")
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        free, total = torch.cuda.mem_get_info(i)
        print(f"  [{i}] {p.name} capability={p.major}.{p.minor} "
              f"SMs={p.multi_processor_count} mem free {free / 2**30:.2f}"
              f"/{total / 2**30:.2f} GiB")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
