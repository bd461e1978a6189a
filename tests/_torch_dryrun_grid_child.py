"""The dry run's cells that the mesh repairs of ROADMAP C35 made trace, in a
process of their own.

    python tests/_torch_dryrun_grid_child.py OUT.json [PART NPARTS]

Spawned by ``tests/test_torch_dryrun_grid.py``, ``NPARTS`` processes at
once, each tracing every ``NPARTS``-th cell from ``PART`` on (all of them
by default): it joins the 256-rank fake
group of the (16, 16) production mesh (process-wide state, so no test
process joins one) and runs ``dryrun.trace_cell`` on each cell of ``CELLS``
at full width and shape, its depth cut to ``DEPTH`` (the fewest layers that
hold each of the architecture's layer kinds).  The SSM family's train and
prefill cells, which ``trace_cell`` traces at ``dryrun.SCALE_SEQ`` tokens
and scales, are traced at ``SSM_SCALE_SEQ``: the sLSTM's token loop costs
the tracer about 0.3 s a token at one pair in a train step.  It imports ``repro_torch`` only,
never ``jax``, and writes each cell's record (its measured part, or its
error) to OUT.json.
"""
import json
import sys
import time
import traceback
import warnings

import torch

from repro_torch.launch import dryrun, mesh

#: the 13 cells whose trace failed before the repairs (ROADMAP C35)
CELLS = (
    ("deepseek-v3-671b", "decode_32k"),
    ("phi3-mini-3.8b", "decode_32k"),
    ("zamba2-1.2b", "decode_32k"),
    ("qwen2.5-32b", "train_4k"),
    ("llama4-scout-17b-a16e", "train_4k"),
    ("whisper-tiny", "prefill_32k"),
    ("whisper-tiny", "train_4k"),
    ("xlstm-350m", "train_4k"),
    ("xlstm-350m", "prefill_32k"),
    ("xlstm-350m", "decode_32k"),
    ("zamba2-1.2b", "train_4k"),
    ("zamba2-1.2b", "prefill_32k"),
    ("zamba2-1.2b", "long_500k"),
)
#: depth per architecture: one layer of each kind (zamba2's first layer
#: carries the shared attention block; an xlstm pair is an sLSTM and an
#: mLSTM block, and its decode fails from the second pair on)
DEPTH = {
    "deepseek-v3-671b": {"n_layers": 1},
    "phi3-mini-3.8b": {"n_layers": 1},
    "zamba2-1.2b": {"n_layers": 1},
    "qwen2.5-32b": {"n_layers": 1},
    "llama4-scout-17b-a16e": {"n_layers": 1},
    "whisper-tiny": {"n_layers": 1, "n_encoder_layers": 1},
    "xlstm-350m": {"n_layers": 2},
}
XLSTM_DECODE_DEPTH = {"n_layers": 4}
SSM_SCALE_SEQ = 64


def main():
    out_path = sys.argv[1]
    part, nparts = (int(a) for a in sys.argv[2:4]) if len(sys.argv) > 3 \
        else (0, 1)
    warnings.filterwarnings("ignore")
    torch.set_num_threads(1)
    dryrun.SCALE_SEQ = SSM_SCALE_SEQ
    out = {}
    with mesh.fake_group(False):
        for arch, shape in CELLS[part::nparts]:
            over = XLSTM_DECODE_DEPTH if (arch, shape) == (
                "xlstm-350m", "decode_32k") else DEPTH[arch]
            t0 = time.perf_counter()
            try:
                rec = dryrun.trace_cell(arch, shape, False, over)
                rec["status"] = "ok"
            except Exception as e:      # noqa: BLE001 - record, go on
                rec = {"status": "error", "error": str(e)[-2000:],
                       "traceback": traceback.format_exc()[-4000:]}
            rec["wall_s"] = time.perf_counter() - t0
            out[f"{arch}/{shape}"] = rec
            print(f"{arch} {shape}: {rec['status']} {rec['wall_s']:.1f} s",
                  flush=True)
    with open(out_path, "w") as f:
        json.dump(out, f, default=str)


if __name__ == "__main__":
    main()
