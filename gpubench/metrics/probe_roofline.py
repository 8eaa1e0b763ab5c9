"""The AFM probe's kernels against their roofline: the least time the card
could take for each launch at the probe's shapes (``gpubench.flops``: the
exact search ``bmu``, ``drive_cascade``, tail ``cascade_wave`` waves;
bytes at HBM bandwidth or f32 operations at the f32 rate, whichever is
longer) over the kernels' device time in the traced steps. ``bmu``'s
launches are its split search (``rows_kernel`` or ``tile_kernel``) and its
merge; ``drive_cascade``'s operations are left out, since at up to its
16 waves they stay under its bytes."""
import re

from gpubench import flops

SEARCH = re.compile(r"\(anonymous namespace\)::(rows_kernel|tile_kernel)\b")
MERGE = re.compile(r"\(anonymous namespace\)::merge_kernel\b")
DRIVE = re.compile(r"\(anonymous namespace\)::drive_cascade_kernel\b")
WAVE = re.compile(r"\(anonymous namespace\)::cascade_wave_kernel\b")


def read(ctx):
    if "traced_steps" not in ctx:
        return None
    p, b = ctx["probe"], ctx["batch"]
    n, d = p["side"] * p["side"], p["dim"]
    bound = spent = 0.0
    for name, (seconds, count) in ctx["summary"].by_name.items():
        if SEARCH.search(name):
            bound += count * flops.bound_seconds(*flops.bmu_cost(b, n, d))
        elif DRIVE.search(name):
            bound += count * flops.bound_seconds(
                *flops.drive_cascade_cost(n, d, 0))
        elif WAVE.search(name):
            bound += count * flops.bound_seconds(*flops.cascade_wave_cost(n))
        elif not MERGE.search(name):
            continue
        spent += seconds
    return 100.0 * bound / spent if spent else None
