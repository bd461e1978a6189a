"""The dry run's two tables, from the records in
``experiments/torch_dryrun/`` (PyTorch port of ``repro.launch.report``).

  PYTHONPATH=src python -m repro_torch.launch.report > experiments/torch_report.md

The roofline's terms are one rank's time on an NVIDIA H100 80GB HBM3
(SXM, 700 W), NVIDIA's data sheet: ``t_c`` the FLOPs over the bf16 dense
peak, ``t_m`` the products' bytes (``dot_bytes``) over the HBM3 rate,
``t_x`` the wire bytes over the link.  Both production axes are 16 ranks
wide, wider than the 8 cards an NVLink domain of an HGX H100 node holds, so
a ring over either axis crosses nodes and runs at the node's network rate
per card: ``LINK`` is one 400 Gb/s NIC a card (50 GB/s).  Within a node
NVLink 4 gives a card 450 GB/s each way, the bound for collectives
that stay inside 8 cards.  The solver cells' counts are one
rank's already (``per_rank``).
"""
from __future__ import annotations

import json
from pathlib import Path

PEAK = 989e12        # bf16 dense FLOP/s, H100 SXM
HBM = 3.35e12        # HBM3 bytes/s
LINK = 50e9          # one 400 Gb/s NIC a card: rings across nodes
DRYRUN = Path("experiments/torch_dryrun")

PARAMS_B = {
    "phi3-mini-3.8b": (3.7, 3.7), "qwen2.5-32b": (32.8, 32.8),
    "qwen3-8b": (8.0, 8.0), "qwen1.5-110b": (111.2, 111.2),
    "deepseek-v3-671b": (672.0, 37.0),
    "llama4-scout-17b-a16e": (108.6, 16.8),
    "zamba2-1.2b": (1.2, 1.2), "xlstm-350m": (0.35, 0.35),
    "whisper-tiny": (0.039, 0.039), "qwen2-vl-72b": (72.7, 72.7),
}
TOKENS = {"train_4k": 4096 * 256, "prefill_32k": 32768 * 32,
          "decode_32k": 128, "long_500k": 1}


def chips_of(mesh: str) -> int:
    return 256 if mesh == "pod16x16" else 512


def cell_terms(rec: dict, chips: int) -> dict:
    coll = rec.get("collectives") or {}
    wire = coll.get("total_wire_bytes", 0.0)
    if rec.get("per_rank"):
        flops = rec.get("analytic_global_flops") or 0.0
        byts = rec.get("analytic_global_bytes") or 0.0
    else:
        flops = (rec.get("analytic_global_flops") or 0.0) / chips
        byts = (rec.get("analytic_global_dot_bytes") or 0.0) / chips
    t = {"t_c": flops / PEAK, "t_m": byts / HBM, "t_x": wire / LINK}
    t["dominant"] = max(("compute", t["t_c"]), ("memory", t["t_m"]),
                        ("collective", t["t_x"]), key=lambda kv: kv[1])[0]
    arch, shape = rec["arch"], rec["shape"]
    if arch in PARAMS_B and shape in TOKENS:
        act = PARAMS_B[arch][1]
        mult = 3.0 if shape == "train_4k" else 1.0
        mf = 2 * act * 1e9 * TOKENS[shape] * mult / chips
        t["useful"] = mf / flops if flops else 0.0
        bound = max(t["t_c"], t["t_m"], t["t_x"])
        t["frac"] = (mf / PEAK) / bound if bound else 0.0
    return t


def _records(mesh: str, root: Path):
    for f in sorted((root / mesh).glob("*.json")):
        yield json.loads(f.read_text())


def dryrun_table(mesh: str, root: Path = DRYRUN) -> str:
    chips = chips_of(mesh)
    lines = [
        f"### {mesh} ({chips} ranks; CPU, fake process group)",
        "",
        "| arch | shape | status | trace s | peak GiB/rank | flops/rank | "
        "HBM bytes/rank | wire B/rank | collectives |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in _records(mesh, root):
        if r["status"] == "skip":
            lines.append(f"| {r['arch']} | {r['shape']} | SKIP "
                         f"({r['reason'][:40]}...) | | | | | | |")
            continue
        if r["status"] != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | ERROR | | | | | "
                         f"| |")
            continue
        t = cell_terms(r, chips)
        peak = r["memory"].get("peak_memory_in_bytes", 0) / 2 ** 30
        cc = r["collectives"]["counts"]
        cstr = " ".join(f"{k.split('-')[-1][:4]}:{v:g}"
                        for k, v in sorted(cc.items()))
        lines.append(
            f"| {r['arch']} | {r['shape']} | ok | {r['trace_s']:.0f} "
            f"| {peak:.2f} | {t['t_c'] * PEAK:.2e} | {t['t_m'] * HBM:.2e} "
            f"| {r['collectives']['total_wire_bytes']:.2e} | {cstr} |")
    return "\n".join(lines)


def roofline_table(mesh: str = "pod16x16", root: Path = DRYRUN) -> str:
    chips = chips_of(mesh)
    lines = [
        "| arch | shape | t_compute ms | t_memory ms | t_collective ms | "
        "dominant | MODEL/counted | roofline frac |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in _records(mesh, root):
        if r["status"] != "ok":
            continue
        t = cell_terms(r, chips)
        lines.append(
            f"| {r['arch']} | {r['shape']} | {t['t_c'] * 1e3:.2f} "
            f"| {t['t_m'] * 1e3:.2f} | {t['t_x'] * 1e3:.2f} | {t['dominant']} "
            f"| {t.get('useful', 0):.2f} | {t.get('frac', 0):.3f} |")
    return "\n".join(lines)


def main():
    for mesh in ("pod16x16", "pod2x16x16"):
        print(dryrun_table(mesh))
        print()
    print("### Roofline (single pod, per rank, H100 80GB HBM3 at 700 W)")
    print()
    print(roofline_table("pod16x16"))


if __name__ == "__main__":
    main()
