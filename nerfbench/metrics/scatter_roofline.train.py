"""scatter_roofline.train: the least time of the traced steps' hash-table
gradients (metrics/work_hash.py: distinct entries written once, each
point's feature gradient read once, at 3.35 TB/s) over the device time of
the kernel that scatters them, %."""
from nerfbench.metrics import work

KERNELS = ("scatter_add_rows_kernel<",)


def read(w):
    seconds = w.kernel_seconds(lambda n: any(k in n for k in KERNELS))
    if "hash_grad_bytes" not in w.work or seconds <= 0:
        return None
    return work.roofline_share(w.work["hash_grad_bytes"], 0.0, seconds)
