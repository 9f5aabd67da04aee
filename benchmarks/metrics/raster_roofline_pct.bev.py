"""The BEV raster kernels' share of their roofline, in percent.

The bytes the two rasters need at the cell's batch, as ``chip_smoke.py``'s
``raster_case`` counts them: each slot's xyz and label (16 B) read once and
both rasters (1 B a cell: the multi-layer and the single-layer BEV) written
once, for every batch of the window, over the device time of the raster's
kernels (``csrc/bev_raster.cu``: ``bev_raster_kernel`` and
``bev_expand_kernel``), against the H100's 3.35 TB/s (NVIDIA's data sheet,
SXM, 700 W).  The card's power limit is printed with the run."""

KERNELS = ("bev_raster_kernel", "bev_expand_kernel")
H100_BYTES_PER_S = 3.35e12


def read(trace, cell):
    events = trace.named(KERNELS)
    if not events or not trace.batches:
        return None
    cfg, batch = cell.config, int(cell.traffic["batch"])
    slots = int(cfg["sensor"]["n_scan"]) * int(cfg["sensor"]["horizon_scan"])
    mat = int(cfg["multi_bev"]["max_range"] * 2 / cfg["multi_bev"]["interval"])
    cells = (int(cfg["multi_bev"]["num_layers"]) + 1) * mat * mat
    need = trace.batches * batch * (slots * 16 + cells)
    seconds = sum(e.dur_us for e in events) / 1e6
    return 100.0 * need / H100_BYTES_PER_S / seconds
