"""The dry-run and roofline tables from the per-cell records that
``repro_torch.launch.dryrun`` writes.

Counterpart of ``repro.roofline.report``. The numbers are analytic: each
record is a trace on the meta device, per device of its mesh (the dense and
moe families on the reference's ``16x16`` and ``2x16x16`` ``("data",
"model")`` meshes, the others on ``data256`` and ``data512``; each table
cell names its record's mesh), and the roofline terms divide it by the
H100 data-sheet rates of ``roofline.analysis`` (``PEAK_FLOPS`` bf16 dense,
``HBM_BW``, ``NVLINK_BW``)::

  PYTHONPATH=src python -m repro_torch.roofline.report [--results results/dryrun] [--write]
"""

from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch import configs
from repro_torch.roofline import analysis

__all__ = ["build_tables", "main", "roofline_row"]

#: the meshes of the two table columns (one pod, two pods), as the dry run
#: names them: the model-axis mesh where a config has one, else the data mesh
MESHES = (("16x16", "data256"), ("2x16x16", "data512"))


def _load(results: pathlib.Path, mesh: str) -> dict[tuple[str, str], dict]:
    out = {}
    for f in sorted((results / mesh).glob("*.json")):
        rec = json.loads(f.read_text())
        if rec.get("tag"):
            continue  # perf-experiment records are reported apart
        out[(rec["arch"], rec["shape"])] = rec
    return out


def _leaves(tree, names=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, (*names, k))
        else:
            yield (*names, k), v


def _n_params(cfg) -> tuple[int, int]:
    """(non-embedding, active) parameter counts from the parameter tree,
    made on the meta device."""
    from repro_torch import random as rnd
    from repro_torch.models import transformer

    params = transformer.init_params(cfg, rnd.key(0), device="meta")
    total = emb = routed = 0
    for names, leaf in _leaves(params):
        sz = leaf.numel()
        total += sz
        if names[-1] in ("embed", "out_head"):
            emb += sz
        if "moe" in names and names[-1] in ("w1", "w2", "w3") and "shared" not in names:
            routed += sz
    non_emb = total - emb
    active = non_emb
    if cfg.n_experts:
        active = non_emb - routed + routed * cfg.top_k / cfg.n_experts
    return int(non_emb), int(active)


def roofline_row(rec: dict, cfg, shape) -> dict:
    """One roofline row of a record: the three terms on one H100, the
    analytic model FLOPs over the traced FLOPs, and the share of the peak
    the useful FLOPs reach at the bound."""
    chips = rec["chips"]
    probe = rec.get("probe")
    if probe:
        c = probe["extrapolated"]
        flops, hbm, coll = c["flops"], c["bytes_accessed"], c["collective_bytes"]
        source = "probe-extrapolated"
    else:
        flops = rec["flops"]
        hbm = rec["bytes_accessed"]
        coll = rec["collectives"]["total_bytes"]
        source = "eager trace (every layer)"
    terms = analysis.terms_from_costs(flops, hbm, coll)
    n_total, n_active = _n_params(cfg)
    mf = analysis.model_flops(cfg, shape, n_total, n_active)
    mf_dev = mf / chips
    useful = mf_dev / flops if flops else 0.0
    bound = terms.bound_s
    mfu_at_bound = mf_dev / analysis.PEAK_FLOPS / bound if bound else 0.0
    return {
        "arch": rec["arch"],
        "shape": rec["shape"],
        "compute_s": terms.compute_s,
        "memory_s": terms.memory_s,
        "collective_s": terms.collective_s,
        "dominant": terms.dominant,
        "model_flops_ratio": useful,
        "roofline_fraction": mfu_at_bound,
        "peak_gib": rec["memory"]["peak_bytes_est"] / 2**30,
        "source": source,
    }


def _dry_cells(rec: dict | None) -> tuple[str, str, str, str]:
    """(mesh, peak GiB, trace s, batch split) of a record, or placeholders."""
    if rec is None:
        return "—", "…", "—", "—"
    split = ("split" if rec["batch_split"]
             else f"whole ({rec['per_rank_batch']} on every rank)")
    return (rec["mesh"], f"{rec['memory']['peak_bytes_est'] / 2**30:.2f}", f"{rec['trace_s']:.1f}",
            split)


def _record(loaded: dict, column: tuple[str, ...], cell) -> dict | None:
    """A cell's record in a table column: on its model-axis mesh, else on
    its data mesh."""
    return next((loaded[m][cell] for m in column if cell in loaded[m]), None)


def build_tables(results: pathlib.Path) -> tuple[str, str, list[dict]]:
    """(the dry-run table, the roofline table of one pod, its rows)."""
    loaded = {m: _load(results, m) for column in MESHES for m in column}
    head = " | ".join(f"{p} mesh | peak GiB | trace s | batch" for p in ("pod", "2 pods"))
    dry = [f"| arch | shape | {head} |", "|---|---|" + "---|" * (4 * len(MESHES))]
    runnable = set(configs.runnable_cells())
    for arch in configs.ARCHS:
        for sname in configs.SHAPES:
            if (arch, sname) not in runnable:
                na = " | ".join("— | N/A (full attention) | — | —" for _ in MESHES)
                dry.append(f"| {arch} | {sname} | {na} |")
                continue
            cells = " | ".join(" | ".join(_dry_cells(_record(loaded, c, (arch, sname))))
                               for c in MESHES)
            dry.append(f"| {arch} | {sname} | {cells} |")

    roof = [
        "| arch | shape | mesh | compute s | memory s (ub) | collective s | dominant "
        "| comp:coll | MODEL/traced | roofline frac | to move the dominant term |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    rows = []
    for arch in configs.ARCHS:
        for sname in configs.SHAPES:
            rec = _record(loaded, MESHES[0], (arch, sname))
            if rec is None:
                continue
            shape = configs.SHAPES[sname]
            row = roofline_row(rec, configs.get_config(arch), shape)
            rows.append(row)
            cc = (f"{row['compute_s'] / max(row['collective_s'], 1e-12):.1f}"
                  if row["collective_s"] > 0 else "∞")
            roof.append(
                f"| {row['arch']} | {row['shape']} | {rec['mesh']} | {row['compute_s']:.3e} | "
                f"{row['memory_s']:.3e} | {row['collective_s']:.3e} | "
                f"{row['dominant']} | {cc} | {row['model_flops_ratio']:.2f} | "
                f"{row['roofline_fraction']:.1%} | {_advice(row, shape, rec)} |"
            )
    return "\n".join(dry), "\n".join(roof), rows


def _advice(row: dict, shape, rec: dict) -> str:
    comp, coll = row["compute_s"], row["collective_s"]
    if not rec.get("batch_split", True):
        return (f"the batch of {shape.global_batch} does not divide the {rec['chips']} ranks, so "
                "every rank runs it whole: serve or train it on fewer cards")
    if shape.kind == "decode":
        if shape.global_batch == 1:
            return "latency-bound by design (batch 1): batch requests or serve from fewer cards"
        return "cache reads dominate: quantize KV (the BWKM codebook path) or raise decode batch"
    if coll > comp:
        return "collective-heavy: bf16 gathers, overlap NVLink transfers with compute"
    if row["model_flops_ratio"] < 0.8:
        return "recompute/dispatch waste: relax remat policy, trim MoE capacity"
    return ("near compute-bound: the memory term is the unfused upper bound; on the H100 "
            "expect MFU ≈ MODEL/traced × compute share")


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.roofline.report")
    ap.add_argument("--results", default="results/dryrun")
    ap.add_argument("--write", action="store_true",
                    help="inject tables into EXPERIMENTS.md at the markers")
    args = ap.parse_args(argv)
    dry, roof, rows = build_tables(pathlib.Path(args.results))
    if args.write:
        doc = pathlib.Path("EXPERIMENTS.md")
        text = doc.read_text()
        if "<!-- DRYRUN_TABLE -->" not in text and "<!-- ROOFLINE_TABLE -->" not in text:
            raise SystemExit(f"{doc} has no <!-- DRYRUN_TABLE --> or <!-- ROOFLINE_TABLE --> "
                             "marker")
        text = text.replace("<!-- DRYRUN_TABLE -->", dry)
        text = text.replace("<!-- ROOFLINE_TABLE -->", roof)
        doc.write_text(text)
        print(f"wrote tables into {doc} ({len(rows)} roofline rows)")
    else:
        print(dry)
        print()
        print(roof)
    return rows


if __name__ == "__main__":
    main()
