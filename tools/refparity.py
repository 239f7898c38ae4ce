#!/usr/bin/env python
"""Build REFPARITY.json: side-by-side per-problem status of the ACTUAL
reference binary (uno_baseline nlsweep over the emitted .nl corpus) vs
uno_tpu's own sweep (the measured denominator for the BASELINE
'CUTEst solved count within 1% of Uno ipopt' row).

Usage (single preset):
  python tools/refparity.py <ref_sweep.jsonl> <our_sweep.json> \
      <nl_manifest.json> [--out REFPARITY.json] [--preset ipopt]
Usage (all presets):
  python tools/refparity.py --multi <refsweep_dir> <our_ipopt.json> \
      <our_sqp.json> <nl_manifest.json> [--out REFPARITY.json]

ref_sweep.jsonl: one JSON object per line from `uno_baseline nlsweep`.
our_sweep.json:  tools/sweep.py --out artifact (rows per preset).
nl_manifest.json: the transcriber's manifest (per-problem f_star + status).
"""

from __future__ import annotations

import json
import sys

RTOL = 1e-4   # reference CI tolerance (runtests_uno_ipopt_ma27.jl:70-75)

# reference OptimizationStatus / IterateStatus (Result.hpp, IterateStatus.hpp)
OPT_STATUS = {0: "success", 1: "iteration_limit", 2: "time_limit",
              3: "evaluation_error", 4: "algorithmic_error", -1: "bridge_error"}
IT_STATUS = {0: "not_optimal", 1: "feasible_kkt_point", 2: "feasible_fj_point",
             3: "infeasible_stationary_point", 4: "feasible_small_step",
             5: "infeasible_small_step", 6: "unbounded"}


def load_ref(path):
    # robust line parse: the harness's stdout occasionally interleaves a
    # stray fragment under heavy load; skip non-JSON lines
    ref = {}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue
            ref[row["name"]] = row
    return ref


def compare(preset, ref, ours, manifest):

    rows = []
    agree = 0
    ref_solved = ours_solved = both = 0
    for name, m in sorted(manifest.items()):
        if m["status"] != "ok":
            continue
        r = ref.get(name)
        o = ours.get(name)
        if r is None or o is None:
            continue
        f_star = m.get("f_star")
        # reference 'solved': SUCCESS + feasible KKT/small-step + objective
        # at a known optimum when one is certified (same rule as
        # tools/sweep.py applies to uno_tpu)
        r_obj = r.get("objective")
        r_ok = (r.get("status") == 0 and r.get("iterate_status") in (1, 4))
        if r_ok and f_star is not None and r_obj is not None:
            r_ok = abs(r_obj - f_star) / max(1.0, abs(f_star)) <= RTOL
        elif r_ok and f_star is not None and r_obj is None:
            r_ok = False
        o_ok = bool(o["solved"])
        ref_solved += r_ok
        ours_solved += o_ok
        both += r_ok and o_ok
        agree += r_ok == o_ok
        rows.append({
            "name": name, "n": m.get("n"), "m": m.get("m"),
            "f_star": f_star,
            "ref_status": OPT_STATUS.get(r.get("status"), r.get("status")),
            "ref_iterate_status": IT_STATUS.get(r.get("iterate_status")),
            "ref_error": r.get("error"),
            "ref_objective": r_obj,
            "ref_iterations": r.get("iterations"),
            "ref_solved": bool(r_ok),
            "uno_tpu_status": o["status"],
            "uno_tpu_objective": None if o["f"] != o["f"] else o["f"],
            "uno_tpu_iterations": o["iters"],
            "uno_tpu_solved": o_ok,
        })

    n = len(rows)
    ref_time_limited = sum(1 for r in rows
                           if r["ref_status"] == "time_limit")
    # BASELINE's criterion is "solved count within 1% of Uno ipopt" —
    # exceeding the reference passes; only a DEFICIT beyond 1% fails
    summary = {
        "preset": preset,
        "ref_size_cap": (None if preset == "ipopt" else
                         "n+m<=150 (SLP's 2000-iteration tail makes the "
                         "extended tier a multi-hour run on both sides; "
                         "documented exclusion)" if preset == "filterslp"
                         else "n+m<=600 (round-4 verdict item 2: the "
                         "extended tier both sides now sweep)"),
        "corpus": n,
        "reference_solved": ref_solved,
        "uno_tpu_solved": ours_solved,
        "both_solved": both,
        "status_agreement": agree,
        "ref_minus_ours": ref_solved - ours_solved,
        "ref_time_limited_rows": ref_time_limited,
        "time_limit_caveat": ("reference rows with status time_limit hit "
                              "the per-problem wall cap (120 s; 1800 s on "
                              "retried n=1000 ipopt rows) — the SAME cap "
                              "the uno_tpu sweep runs under (round 5: "
                              "--time-limit 120), so capped rows count "
                              "unsolved symmetrically on both sides")
        if ref_time_limited else None,
        "within_1pct": ours_solved >= ref_solved - max(1, round(0.01 * n)),
        "exceeds_reference": ours_solved > ref_solved,
        "note": (f"reference = /root/reference libuno ({preset} preset; "
                 "LAPACK LDL^T behind the MA27/MA57 seam, the in-repo "
                 "IP-QP behind the BQPD/HiGHS seams, postfix-AD .nl "
                 "models replacing ASL); identical .nl corpus, identical "
                 "solved rule: SUCCESS + feasible KKT/small-step + "
                 "|f-f*| <= 1e-4 rel when a certified optimum exists"),
    }
    disagreements = [r["name"] for r in rows
                     if r["ref_solved"] != r["uno_tpu_solved"]]
    return summary, disagreements, rows


def main():
    import os
    argv = sys.argv[1:]
    out_file = "REFPARITY.json"
    if "--out" in argv:
        i = argv.index("--out"); out_file = argv[i + 1]; del argv[i:i + 2]
    if "--multi" in argv:
        argv.remove("--multi")
        ref_dir, ours_ipopt, ours_sqp, manifest_path = argv[:4]
        manifest = json.load(open(manifest_path))["problems"]
        doc_ip = json.load(open(ours_ipopt))
        doc_sqp = json.load(open(ours_sqp))
        out = {"presets": {}, "rows": {}, "disagreements": {}}
        for preset in ("ipopt", "filtersqp", "funnelsqp", "byrd",
                       "filterslp"):
            ref_path = os.path.join(ref_dir, f"{preset}.jsonl")
            if not os.path.exists(ref_path):
                continue
            ours_doc = doc_ip if preset == "ipopt" else doc_sqp
            if preset not in ours_doc["rows"]:
                continue
            ours = {r["name"]: r for r in ours_doc["rows"][preset]}
            summary, disagreements, rows = compare(
                preset, load_ref(ref_path), ours, manifest)
            out["presets"][preset] = summary
            out["disagreements"][preset] = disagreements
            out["rows"][preset] = rows
            print(json.dumps(summary, indent=1))
        json.dump(out, open(out_file, "w"), indent=1)
        return

    preset = "ipopt"
    if "--preset" in argv:
        i = argv.index("--preset"); preset = argv[i + 1]; del argv[i:i + 2]
    ref_path, ours_path, manifest_path = argv[:3]
    ours_doc = json.load(open(ours_path))
    manifest = json.load(open(manifest_path))["problems"]
    ours = {r["name"]: r for r in ours_doc["rows"][preset]}
    summary, disagreements, rows = compare(preset, load_ref(ref_path),
                                           ours, manifest)
    json.dump({"summary": summary, "disagreements": disagreements,
               "rows": rows},
              open(out_file, "w"), indent=1)
    print(json.dumps(summary, indent=1))
    print("disagreements:", disagreements)


if __name__ == "__main__":
    main()
