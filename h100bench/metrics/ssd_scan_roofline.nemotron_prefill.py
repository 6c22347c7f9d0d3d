"""``ssd_scan_roofline.nemotron_prefill``: the least time of the window's SSD
scan calls, 64 heads with B and C in eight groups at chunk 128
(``h100bench/work/ssd_groups.py``: the inputs read once, y written once, the
chunked algorithm's products, C B^T once per group), over the device time of
the kernels a call launches, named here with their launches a call, in %."""

from h100bench.readers import kernel_roofline

KERNELS = {"ssd_scan_cb_kernel": 1, "ssd_scan_kernel": 1}


def read(run):
    return kernel_roofline(run, KERNELS, "ssd_scan")
