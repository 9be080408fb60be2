"""Share (%) of its roofline that ``collision_count_batch``
(``kernels/ops`` -> ``csrc/collision_count.cu``) reaches in the traced
window: the least time the chip could take for a launch of the cell's
shapes over the profiler's device time a launch.

The work is fixed by the shapes: a block's B·O query rows (the block
times the multiprobe offsets) against the N database rows, one int32
compare a (query row, database row, hash) of the K hashes; the database
and query signatures read once and the (B·O, N) int32 counts written
once.  The bound is the larger of compares over the card's int32 rate
and bytes over its memory bandwidth (``portbench/peaks.json``)."""
from portbench import peaks


def bound_s(rows: int, n: int, k: int, peak: dict) -> float:
    ops = rows * n * k
    nbytes = 4 * (n * k + rows * k + rows * n)
    return max(ops / peak["int32_ops_per_s"],
               nbytes / peak["hbm_bytes_per_s"])


def read(obs):
    if obs.trace is None:
        return None
    seconds, launches = obs.trace.kernel("collision_count_batch_kernel")
    peak = peaks.of(obs.harness.device)
    if not launches or seconds <= 0 or peak is None:
        return None
    cell = obs.cell
    rows = int(cell.traffic["block"]) * cell.offsets
    k = int(cell.config["params"]["num_hashes"])
    return 100.0 * bound_s(rows, cell.n_rows, k, peak) / (seconds / launches)
