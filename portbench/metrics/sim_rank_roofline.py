"""The similarity-and-rank operation's share of its roofline: the least
time the card could take for it (portbench/yardstick.py sim_rank_bound,
one a pass) over the device time of the rank kernels of csrc/sim_rank.cu
in the traced window."""

from portbench.yardstick import sim_rank_bound

KERNELS = ("sim_rank", "mark_gt_tiles", "list_gt_tiles", "gt_dot")


def read(ctx):
    if not ctx.get("passes") or "sim_rank" not in ctx:
        return None
    seconds = sum(s for name, s in ctx["trace"]["ops"].items()
                  if any(k in name for k in KERNELS))
    if seconds <= 0:
        return None
    return 100.0 * ctx["passes"] * sim_rank_bound(*ctx["sim_rank"]) / seconds
