"""Production-mesh dry run: one fake-mode trace per (arch x shape x mesh)
cell (PyTorch port of ``repro.launch.dryrun``).

Nothing is compiled and nothing is allocated.  The process joins a fake
process group of 256 or 512 ranks (:func:`repro_torch.launch.mesh
.init_fake_group`: every collective returns at once) as rank 0, builds the
full-size model under ``FakeTensorMode`` (tensors with shapes, dtypes and
devices and no data), places it on the production mesh as the JAX
package's rules say, and runs the step function once: a train step (loss,
grad, AdamW), ``prefill_step`` or ``decode_step``.  Each cell's record,
``experiments/torch_dryrun/<mesh>/<arch>__<shape>.json``, holds:

* ``memory``: one rank's ``argument_size_in_bytes`` (its shards of the
  parameters, the AdamW moments and the inputs), ``output_size_in_bytes``
  and ``peak_memory_in_bytes``, the most bytes of live storages the step
  held at once (:class:`~repro_torch.launch.flops.Counter`);
* ``analytic_global_flops`` / ``_bytes`` / ``_dot_bytes``: the step counted
  unsharded (:mod:`repro_torch.launch.flops`), global as the JAX package's;
  ``per_rank_flops``: the sharded trace's one rank;
* ``collectives``: ``counts``, ``result_bytes`` and ``wire_bytes`` by kind
  and ``total_wire_bytes``, one rank's, seen as DTensor issues them (the
  redistributions between the ops' placements, the gradients' reductions);
  the fake group is a CPU one, which runs an all-to-all as an all-gather;
* ``trace_s`` (the two traces) where the JAX record has ``lower_s`` and
  ``compile_s``.

No torch meaning, so not recorded: the HLO text, ``cost_analysis`` (XLA's
per-op costs) and ``tpu_wire_bytes`` (XLA:CPU's bf16 legalization: DTensor
moves the dtype the program holds).  ``launch/hlo_analysis.py`` has no
counterpart for that reason (ROADMAP, "No counterpart, by design").

A cell whose sequence runs through the sLSTM's token loop (the SSM family's
train and prefill) is traced at ``SCALE_SEQ`` tokens and its counts scaled
by S / SCALE_SEQ, exact for a model whose every cost is linear in S; the
record says so in ``scaled_from``; its peak is the traced one's.

  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.configs import (ARCH_IDS, SHAPES, ShapeSpec, get_config,
                                 input_specs, skip_reason)
from repro_torch.models import (cache_logical_axes, decode_step, init_cache,
                                init_params, prefill_step)
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.parallel import LogicalMesh, PartitionSpec
from repro_torch.parallel.sharding import mesh_context
from repro_torch.train.train_loop import (loss_and_grads, place_model,
                                          place_opt_state)

from .flops import Counter
from .mesh import fake_group, make_production_mesh, mesh_name

OUT = Path("experiments/torch_dryrun")
#: 8-bit optimizer states for the very large configs (the JAX package's)
I8_STATE_ARCHS = {"deepseek-v3-671b", "qwen1.5-110b", "qwen2-vl-72b",
                  "llama4-scout-17b-a16e"}
#: the SSM family's train and prefill cells are traced at this many tokens
SCALE_SEQ = 1024


def opt_config(arch: str) -> AdamWConfig:
    return AdamWConfig(state_dtype="i8" if arch in I8_STATE_ARCHS else "f32")


def div_spec(lm: LogicalMesh, shape, *logical) -> PartitionSpec:
    """The spec of ``logical`` names, a name dropped where its axes do not
    divide the dimension (the JAX package's ``_div_spec``)."""
    parts = []
    for dim, name in zip(shape, logical):
        ax = lm.axes_for(name)
        n = lm.size(name) if name else 1
        parts.append(ax if ax is not None and dim % max(n, 1) == 0
                     and dim >= n else None)
    return PartitionSpec(*parts)


@dataclasses.dataclass
class Cell:
    """One built cell: ``fn()`` runs its step once; ``arguments`` are what
    the step reads (parameters, moments, inputs), placed on the cell's
    mesh (or whole); ``cfg`` its config."""
    cfg: Any
    arguments: Dict[str, Any]
    fn: Callable[[], Any]


def _inputs(cfg, sp: ShapeSpec, device, generator) -> Dict[str, Any]:
    """Concrete inputs of ``input_specs``' shapes on ``device`` (fake ones
    under ``FakeTensorMode``): random tokens below the vocabulary, random
    frames and patch embeddings, arange positions, a zero cache."""
    specs = input_specs(cfg, sp)

    def make(t: torch.Tensor) -> torch.Tensor:
        if t.dtype == torch.int32:
            return torch.randint(0, cfg.vocab_size, t.shape,
                                 generator=generator, dtype=torch.int32,
                                 device=device)
        return torch.randn(t.shape, generator=generator, dtype=t.dtype,
                           device=device)

    if sp.kind != "decode":
        batch = {k: make(v) for k, v in specs["batch"].items()}
        if "positions" in batch:
            S = sp.seq_len
            batch["positions"] = torch.arange(
                S, dtype=torch.int32, device=device)[None, :, None].expand(
                sp.global_batch, S, 3).contiguous()
        return {"batch": batch}
    return {"tokens": make(specs["tokens"]),
            "cache": init_cache(cfg, sp.global_batch, sp.seq_len,
                                device=device,
                                enc_len=1500 if cfg.family == "audio" else 0),
            "cache_len": torch.zeros((), dtype=torch.int32, device=device)}


def _place(t: torch.Tensor, lm: Optional[LogicalMesh], spec) -> torch.Tensor:
    if lm is None:
        return t
    return distribute_tensor(t, lm.mesh, lm.placements(spec))


def build_cell(arch: str, shape, multi_pod: bool = False,
               overrides: Optional[dict] = None, *,
               lm: Optional[LogicalMesh] = None, sharded: bool = True,
               device="cpu", seed: int = 0) -> Cell:
    """Build the cell (arch, shape): the config (``overrides`` replaced in
    it), its parameters from ``seed`` on ``device``, placed by
    ``parallel.module_param_specs``; for a train shape the AdamW moments
    (8-bit for ``I8_STATE_ARCHS``) placed by ``place_opt_state``; the
    inputs, each batch leaf sharded on ``"batch"`` and the cache by
    ``cache_logical_axes``, with ``div_spec``'s fallback.  ``shape`` is a
    name of ``SHAPES`` or a :class:`ShapeSpec`; ``lm`` the mesh (default:
    the production mesh over the initialized group, made outside any fake
    mode); ``sharded=False`` builds it whole, on no mesh.  Call it under
    ``FakeTensorMode`` to allocate nothing."""
    sp = SHAPES[shape] if isinstance(shape, str) else shape
    if sharded and lm is None:
        lm = LogicalMesh(make_production_mesh(multi_pod=multi_pod))
    lm = lm if sharded else None
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = init_params(cfg, gen)
    specs = place_model(model, lm) if lm is not None else None
    params = dict(model.named_parameters())
    inputs = _inputs(cfg, sp, device, gen)
    args: Dict[str, Any] = {"params": params}

    if sp.kind in ("train", "prefill"):
        batch = {k: _place(v, lm, None if lm is None else div_spec(
            lm, v.shape, "batch", *(None,) * (v.dim() - 1)))
            for k, v in inputs["batch"].items()}
        args["batch"] = batch
        if sp.kind == "train":
            ocfg = opt_config(arch)
            opt = adamw_init(params, ocfg)
            if lm is not None:
                opt = place_opt_state(opt, specs, lm)
            args["opt"] = opt

            def fn():
                loss, _, grads = loss_and_grads(model, cfg, batch, lm)
                with torch.no_grad(), mesh_context(lm):
                    new_p, new_opt = adamw_update(params, grads, opt, ocfg)
                return loss, new_p, new_opt
        else:
            def fn():
                with torch.no_grad(), mesh_context(lm):
                    return prefill_step(model, cfg, batch)
        return Cell(cfg, args, fn)

    axes = cache_logical_axes(cfg)
    cache = {k: _place(v, lm, None if lm is None else div_spec(
        lm, v.shape, *axes[k])) for k, v in inputs["cache"].items()}
    tokens = _place(inputs["tokens"], lm, None if lm is None else div_spec(
        lm, inputs["tokens"].shape, "batch", None))
    cache_len = inputs["cache_len"]
    args.update(cache=cache, tokens=tokens, cache_len=cache_len)

    def fn():
        with torch.no_grad(), mesh_context(lm):
            return decode_step(model, cfg, cache, tokens, cache_len)
    return Cell(cfg, args, fn)


def local_bytes(tree) -> int:
    """One rank's bytes of ``tree``'s tensors (a DTensor's local shard),
    each storage once."""
    seen, total = set(), 0
    for t in torch.utils._pytree.tree_leaves(tree):
        if not isinstance(t, torch.Tensor):
            continue
        t = t._local_tensor if isinstance(t, DTensor) else t
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += st.nbytes()
    return total


def _scaled(sp: ShapeSpec, cfg) -> Optional[ShapeSpec]:
    """The shape traced in place of ``sp`` (see the module's docstring)."""
    if cfg.family == "ssm" and sp.kind != "decode" and sp.seq_len > SCALE_SEQ:
        return dataclasses.replace(sp, seq_len=SCALE_SEQ)
    return None


def trace_cell(arch: str, shape, multi_pod: bool = False,
               overrides: Optional[dict] = None) -> Dict[str, Any]:
    """Build and trace the cell in fake mode on the initialized (fake)
    group: the step counted whole, then sharded; returns the record's
    measured part."""
    sp = SHAPES[shape] if isinstance(shape, str) else shape
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    small = _scaled(sp, cfg)
    traced = small or sp
    factor = sp.seq_len / traced.seq_len
    rec: Dict[str, Any] = {}
    lm = LogicalMesh(make_production_mesh(multi_pod=multi_pod))
    with FakeTensorMode(allow_non_fake_inputs=True):
        t0 = time.perf_counter()
        whole = build_cell(arch, traced, multi_pod, overrides, sharded=False)
        with Counter() as count:
            whole.fn()
        del whole
        t1 = time.perf_counter()
        cell = build_cell(arch, traced, multi_pod, overrides, lm=lm)
        t2 = time.perf_counter()
        with Counter(track_memory=True) as mesh_count:
            arg_bytes = mesh_count.hold(cell.arguments)
            out = cell.fn()
        t3 = time.perf_counter()
    totals = count.totals()
    coll = mesh_count.collectives()
    if small is not None:
        totals = {k: v * factor for k, v in totals.items()}
        coll = {"counts": {k: round(v * factor)
                           for k, v in coll["counts"].items()},
                "result_bytes": {k: v * factor
                                 for k, v in coll["result_bytes"].items()},
                "wire_bytes": {k: v * factor
                               for k, v in coll["wire_bytes"].items()},
                "total_wire_bytes": coll["total_wire_bytes"] * factor}
        rec["scaled_from"] = {"seq_len": traced.seq_len, "factor": factor,
                              "scaled": ["analytic_global_*",
                                         "per_rank_flops", "collectives"],
                              "peak_memory_in_bytes": "as traced"}
    rec.update({
        "memory": {"argument_size_in_bytes": arg_bytes,
                   "output_size_in_bytes": local_bytes(out),
                   "peak_memory_in_bytes": mesh_count.peak_bytes},
        "analytic_global_flops": totals["flops"],
        "analytic_global_bytes": totals["bytes"],
        "analytic_global_dot_bytes": totals["dot_bytes"],
        "per_rank_flops": mesh_count.flops * factor,
        "collectives": coll,
        "trace_s": round(t3 - t0, 2),
        "count_trace_s": round(t1 - t0, 2),
        "mesh_trace_s": round(t3 - t2, 2),
    })
    return rec


def run_cell(arch: str, shape: str, multi_pod: bool, outdir: Path = OUT,
             force: bool = False, overrides: Optional[dict] = None) -> dict:
    """Trace the cell and write its record (an existing one is returned as
    it is unless ``force``); a skipped cell's record carries
    ``skip_reason``'s string, a failed one its error."""
    name = mesh_name(multi_pod)
    out = Path(outdir) / name / f"{arch}__{shape}.json"
    if out.exists() and not force:
        return json.loads(out.read_text())
    out.parent.mkdir(parents=True, exist_ok=True)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape, "mesh": name}
    reason = skip_reason(arch, shape)
    if reason:
        rec.update(status="skip", reason=reason)
        out.write_text(json.dumps(rec, indent=2))
        return rec
    try:
        with fake_group(multi_pod):
            rec.update(trace_cell(arch, shape, multi_pod, overrides))
        rec["status"] = "ok"
        c = rec["collectives"]
        print(f"[ok] {name} {arch} {shape}: trace {rec['trace_s']:.1f}s "
              f"flops={rec['analytic_global_flops']:.3e} "
              f"peak={rec['memory']['peak_memory_in_bytes'] / 2**30:.2f}GiB "
              f"wire={c['total_wire_bytes']:.3e}B", flush=True)
    except Exception as e:  # noqa: BLE001 - record the cell, go on
        rec.update(status="error", error=str(e)[-4000:],
                   traceback=traceback.format_exc()[-8000:])
        print(f"[ERR] {name} {arch} {shape}: {str(e)[:300]}", flush=True)
    out.write_text(json.dumps(rec, indent=2))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    n_err = 0
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                rec = run_cell(arch, shape, mp, Path(args.out),
                               force=args.force)
                n_err += rec.get("status") == "error"
    print(f"done, {n_err} errors")
    raise SystemExit(1 if n_err else 0)


if __name__ == "__main__":
    main()
