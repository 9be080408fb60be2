"""Share of the probe's top-C slots that the tie order decides:
``SearchStats.topc_tie_slots`` (the slots each query filled from its
threshold count, so by id alone) over blocks x B x C, summed over the
window's blocks, with B the traffic's block and C = min(top_c, rows).
Each query fills at least one such slot; 1 is every slot.  A program
without the counter reads nothing."""


def read(obs):
    stats = [s for s in obs.block_stats()
             if s is not None and hasattr(s, "topc_tie_slots")]
    if not stats:
        return None
    cell = obs.cell
    slots = int(cell.traffic["block"]) * min(int(cell.config["top_c"]),
                                             cell.n_rows)
    return sum(s.topc_tie_slots for s in stats) / (len(stats) * slots)
