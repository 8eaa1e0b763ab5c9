"""What decides ``correct``: the numbers that compare the program's
outputs with the plain reference's, each held to the limit that
``cells/<workload>.json`` gives it (``limits``).

Each kind (``kinds/<kind>.py``) says what its numbers are, in its
``numbers(program, reference, check)``; this module judges them against
the limits.
"""
from __future__ import annotations


def judge(nums: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): each number at or under its
    limit; a number that is not finite fails, and so does a limit that no
    number answers. Raises on a number the limits do not name."""
    if set(nums) - set(limits):
        raise KeyError(f"no limit for {sorted(set(nums) - set(limits))}")
    report = {k: {"value": nums.get(k, float("nan")), "limit": v}
              for k, v in limits.items()}
    ok = all(r["value"] == r["value"] and r["value"] <= r["limit"]
             for r in report.values())
    return ok, report
