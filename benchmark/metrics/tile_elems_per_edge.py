"""The tile elements of the BCSR unions that the program's batches made in
the traced window over their real edges (self-loops included): the
program's counters (``InductiveTrainer.counters``), as the cell's loop
reads them where the traced part starts and where it ends. What the flash
kernels sweep an edge, which the node order decides."""


def read(run: dict):
    c = run["shape"].get("counters")
    if not run["trace"] or not c or c.get("edges", 0) <= 0 or c.get("tile_elems", 0) <= 0:
        return None
    return c["tile_elems"] / c["edges"]
