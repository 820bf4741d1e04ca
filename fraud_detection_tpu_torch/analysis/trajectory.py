"""Bench-trajectory regression tracking (the JAX package's
``analysis/trajectory.py``).

A bench run's headline numbers append to a trajectory file, and the gate
fails when a headline regresses more than the tolerance against the
previous comparable entry. Entries carry a host fingerprint (the machine,
its CPU count and the serving device); the gate compares only against the
latest entry with the SAME fingerprint and appends ungated otherwise (a
new host seeds its own baseline). Ratio-like headlines (overhead
fractions) carry an absolute slack so noise on a near-zero number cannot
fail the gate. The headline table, the entries and the messages are
JAX's, so either package's bench files read alike.

Two departures from JAX: the fingerprint reads ``DEVICE`` where JAX reads
``JAX_PLATFORMS`` (``"default"`` when unset), and ``--trajectory`` is
required — JAX's default, ``BENCH_TRAJECTORY.json`` in the working
directory, is the JAX package's committed file at the repository root.

CLI::

    python -m fraud_detection_tpu_torch.analysis.trajectory \\
        bench-flush.json bench-online.json \\
        --trajectory trajectory.json --tolerance 0.15

Exit 1 on regression, 2 on a usage error; the updated trajectory is
written either way so the artifact shows exactly what was compared.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

#: headline keys harvested from the bench JSON lines:
#: name → (source key, direction, absolute slack). Direction "higher"
#: regresses when the new value drops below previous*(1-tol); "lower"
#: when it rises above previous*(1+tol)+slack. The slack keeps
#: near-zero fractions (telemetry overhead) from failing on noise.
HEADLINES: dict[str, tuple[str, str, float]] = {
    "fused_speedup": ("microbatch_flush_speedup", "higher", 0.0),
    "online_rows_per_sec": ("online_binary_rows_per_sec", "higher", 0.0),
    "online_json_rows_per_sec": ("online_json_rows_per_sec", "higher", 0.0),
    "telemetry_overhead_frac": ("telemetry_overhead_frac", "lower", 0.01),
    "explain_cost_ratio": ("explain_cost_ratio", "higher", 0.0),
    "gbt_explain_cost_ratio": ("gbt_explain_cost_ratio", "higher", 0.0),
    "recovery_replay_rows_per_sec": ("recovery_replay_rows_per_sec", "higher", 0.0),
    "recovery_snapshot_overhead_frac": ("recovery_snapshot_overhead_frac", "lower", 0.01),
    "multihost_replay_rows_per_sec": ("multihost_replay_rows_per_sec", "higher", 0.0),
    # failover wall time includes a directory round-trip + socket setup —
    # sub-second but jittery, so an absolute slack carries the noise
    "multihost_failover_s": ("multihost_failover_s", "lower", 0.5),
}


def host_fingerprint() -> str:
    import platform

    backend = os.environ.get("DEVICE", "default")
    return f"{platform.machine()}-cpu{os.cpu_count()}-{backend}"


def harvest(bench_files: list[str]) -> dict[str, float]:
    """Headline numbers present in the given bench JSON lines (missing
    sections simply contribute nothing — the gate only compares keys both
    entries carry)."""
    merged: dict = {}
    for path in bench_files:
        try:
            with open(path, encoding="utf-8") as f:
                merged.update(json.load(f))
        except (OSError, json.JSONDecodeError) as e:
            print(f"trajectory: skipping {path}: {e}", file=sys.stderr)
    out: dict[str, float] = {}
    for name, (key, _, _) in HEADLINES.items():
        v = merged.get(key)
        if isinstance(v, (int, float)):
            out[name] = float(v)
    return out


def load(path: str) -> list[dict]:
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except FileNotFoundError:
        return []
    if not isinstance(data, list):
        raise ValueError(f"{path}: trajectory must be a JSON list")
    return data


def compare(prev: dict, new_headlines: dict[str, float], tolerance: float) -> list[str]:
    """Regressions of ``new_headlines`` vs one previous entry; [] = clean."""
    regressions: list[str] = []
    old = prev.get("headlines", {})
    for name, value in new_headlines.items():
        if name not in old:
            continue
        base = float(old[name])
        _, direction, slack = HEADLINES[name]
        if direction == "higher":
            floor = base * (1.0 - tolerance)
            if value < floor:
                regressions.append(
                    f"{name}: {value:g} < {floor:g} "
                    f"(prev {base:g}, tolerance {tolerance:.0%})"
                )
        else:
            ceil = base * (1.0 + tolerance) + slack
            if value > ceil:
                regressions.append(
                    f"{name}: {value:g} > {ceil:g} "
                    f"(prev {base:g}, tolerance {tolerance:.0%} + {slack:g})"
                )
    return regressions


def append(
    bench_files: list[str],
    trajectory_path: str,
    tolerance: float = 0.15,
    note: str | None = None,
) -> tuple[dict, list[str]]:
    """Harvest, gate against the latest same-host entry, append, write.
    Returns (new entry, regressions)."""
    headlines = harvest(bench_files)
    entries = load(trajectory_path)
    fp = host_fingerprint()
    baseline = next((e for e in reversed(entries) if e.get("host") == fp), None)
    regressions = compare(baseline, headlines, tolerance) if baseline else []
    entry = {
        "ts": int(time.time()),
        "host": fp,
        "note": note,
        "headlines": headlines,
        "regressions": regressions,
        "compared_to": baseline["ts"] if baseline else None,
    }
    entries.append(entry)
    with open(trajectory_path, "w", encoding="utf-8") as f:
        json.dump(entries, f, indent=1)
        f.write("\n")
    return entry, regressions


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fraud_detection_tpu_torch.analysis.trajectory",
        description="append bench headlines to a trajectory file and fail on regression vs "
        "the previous same-host entry",
    )
    ap.add_argument("bench_files", nargs="+", help="bench JSON line files")
    ap.add_argument("--trajectory", required=True,
                    help="the trajectory file to gate against and append to")
    ap.add_argument("--tolerance", type=float, default=0.15)
    ap.add_argument("--note", default=None)
    args = ap.parse_args(argv)
    entry, regressions = append(args.bench_files, args.trajectory, args.tolerance, args.note)
    print(json.dumps(entry, indent=1))
    if regressions:
        print(
            "BENCH TRAJECTORY REGRESSION (>{:.0%} vs previous entry on this "
            "host):".format(args.tolerance),
            file=sys.stderr,
        )
        for r in regressions:
            print(f"  {r}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
