"""Render roofline JSON records into a table, ported from
``repro/roofline/report.py``::

    PYTHONPATH=src python -m repro_torch.roofline.report \\
        [--dir build/roofline] [--mesh h100]

A record is one JSON file ``<arch>_<shape>_<mesh>.json`` holding
``arch``, ``shape``, ``mode``, ``status`` (``"OK"``, or why the cell did
not run), ``memory`` (``argument_bytes`` and ``temp_bytes``: their sum is
the peak) and ``roofline`` (``Roofline.as_dict()``).  ``chip_smoke.py``'s
phase 13 writes one per measured path of the card into
``build/roofline``.  The table is the reference's; its fit mark flags a
peak above the H100's 80 GiB, and rows whose record carries a measured
time (``roofline["measured_s"]``) fill two more columns: the measured
seconds and ``mfu``.  The reference's dry-run table waits for the port's
dry run.
"""
from __future__ import annotations

import argparse
import json
import os

#: device memory of one H100 SXM, GiB: the fit mark's limit
FIT_GIB = 80


def load(d: str, mesh: str):
    rows = []
    for fn in sorted(os.listdir(d)):
        if not fn.endswith(f"_{mesh}.json"):
            continue
        with open(os.path.join(d, fn)) as f:
            rows.append(json.load(f))
    return rows


def fmt_bytes(b):
    return f"{b / 2**30:.1f}"


def render(rows) -> str:
    measured = any("measured_s" in r.get("roofline", {}) for r in rows)
    more = " measured s | mfu |" if measured else ""
    out = []
    out.append("| arch | shape | mode | status | peak GiB/chip | t_compute "
               "| t_memory | t_collective | bottleneck | useful/HLO | "
               "roofline frac |" + more)
    out.append("|---|---|---|---|---|---|---|---|---|---|---|"
               + ("---|---|" if measured else ""))
    order = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2,
             "long_500k": 3}
    rows = sorted(rows, key=lambda r: (r["arch"], order.get(r["shape"], 9)))
    for r in rows:
        arch, shape = r["arch"], r["shape"]
        st = r.get("status", "?")
        if st != "OK":
            short = "SKIP" if st.startswith("SKIP") else "ERROR"
            note = st.split("(", 1)[-1].rstrip(")") if "(" in st else st
            out.append(f"| {arch} | {shape} | {r.get('mode', '')} | {short}:"
                       f" {note[:48]} | | | | | | | |"
                       + (" | |" if measured else ""))
            continue
        rl = r["roofline"]
        m = r["memory"]
        peak = (m["argument_bytes"] + m["temp_bytes"]) / 2**30
        fit = "" if peak <= FIT_GIB else " ⚠"
        tail = ""
        if measured:
            tail = (f" {rl['measured_s']:.4f} | {rl['mfu']:.4f} |"
                    if "measured_s" in rl else " | |")
        out.append(
            f"| {arch} | {shape} | {r.get('mode', '')} | OK | "
            f"{peak:.1f}{fit} | {rl['t_compute_s']:.4f} | "
            f"{rl['t_memory_s']:.4f} | {rl['t_collective_s']:.4f} | "
            f"{rl['bottleneck']} | {rl['useful_flops_ratio']:.2f} | "
            f"{rl['roofline_fraction']:.4f} |" + tail)
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.roofline.report")
    ap.add_argument("--dir", default="build/roofline")
    ap.add_argument("--mesh", default="h100")
    args = ap.parse_args(argv)
    print(render(load(args.dir, args.mesh)))


if __name__ == "__main__":
    main()
