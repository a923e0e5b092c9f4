"""Config U's U3 and U4 solve medians under variants of the port, against
JAX CPU's on several seeds' draws: the readings that set chip_smoke.py's
limits for config U's medians.

    python tools/utility_spread.py [--device cuda|cpu] [--batch 256]
        [--out FILE.json]

For each seed of tools/jax_reference_utility.json (its own and those under
"seeds", written by `tools/jax_reference.py --configs utility
--utility-seeds ...`), at B = --batch (the first elements of any larger
batch of the same seed), each module's median energy after LM 3 (far above
float32 roundoff) and after LM 10 of:

  * on the card: the port as the smoke runs it (K1, K2+K3); the same with
    K1's plain version, with K2+K3's, and with both; two controls: LM 9 in
    place of LM 10 (a solve one iteration short), and U3's centre of mass
    held by bodies whose masses are off by N(0, 1e-3) relative (a wrong
    row);
  * with --device cpu: the port on the CPU (the plain versions, float32).

Each line gives a variant's largest relative gap to JAX CPU's medians over
the modules; the card's lines also give, at LM 3 and LM 10, the median over
the elements of |e − e_plain| / e_plain against the all-plain variant.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

JAX_CPU_FILE = "tools/jax_reference_utility.json"
EARLY, FINAL = 3, 10


@contextlib.contextmanager
def plain(fk_plain: bool, psd_plain: bool):
    """K1 and/or K2+K3 replaced by their plain versions on CUDA tensors."""
    from momentum_tpu_torch.ops import fk as fk_ops, psd

    real = fk_ops._fk_global_kernel, psd.damped_chol_solve
    if fk_plain:
        fk_ops._fk_global_kernel = fk_ops.fk_global_plain
    if psd_plain:
        psd.damped_chol_solve = psd.damped_chol_solve_plain
    try:
        yield
    finally:
        fk_ops._fk_global_kernel, psd.damped_chol_solve = real


def energies(sub, iterations: int) -> dict:
    """Each module's energy (B,) float64 after LM `iterations`."""
    from momentum_tpu_torch.testing import workloads as w

    res = w.solve_catalog(sub, iterations=iterations)
    return {k: v.detach().cpu().numpy().astype(np.float64)
            for k, v in w.catalog_energies(sub, res.params).items()}


def wrong_masses(sub, seed: int):
    """U3's problem with its centre of mass's masses off by N(0, 1e-3)."""
    (pl, pos), (cl, com) = sub.modules
    g = np.random.default_rng(seed + 7).normal(0.0, 1e-3, com.masses.shape[0])
    masses = com.masses * torch.as_tensor(1.0 + g, dtype=com.masses.dtype,
                                          device=com.masses.device)
    return sub._replace(modules=((pl, pos), (cl, dataclasses.replace(com, masses=masses))))


def gap(medians: dict, want: dict) -> float:
    return max(abs(medians[k] - want[k]) / want[k] for k in want)


def main():
    from momentum_tpu_torch.testing import workloads as w
    from momentum_tpu_torch.testing.profile_workload import card_name_and_power_limit

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(here, JAX_CPU_FILE)) as f:
        ref = json.load(f)
    runs = {str(ref["seed"]): dict(u3=ref["u3"], u4=ref["u4"]), **ref["seeds"]}
    where = card_name_and_power_limit() if args.device == "cuda" else "the CPU"
    out = []
    for seed, want in runs.items():
        prob = w.build_utility_problem(args.batch, seed=int(seed), device=args.device)
        for stage, sub in (("u3", prob.scaled), ("u4", prob.simplified)):
            jax_final = want[stage]["median_energy"]
            jax_early = want[stage]["early_median_energy"]
            if args.device == "cuda":
                variants = {"kernels": (False, False, FINAL, sub),
                            "plain K1": (True, False, FINAL, sub),
                            "plain K2+K3": (False, True, FINAL, sub),
                            "plain K1, K2+K3": (True, True, FINAL, sub),
                            "control: LM 9": (False, False, FINAL - 1, sub)}
                if stage == "u3":
                    variants["control: masses off 1e-3"] = (False, False, FINAL,
                                                            wrong_masses(sub, int(seed)))
            else:
                variants = {"cpu": (False, False, FINAL, sub)}
            per = {}
            for name, (fk_plain, psd_plain, iterations, problem) in variants.items():
                with plain(fk_plain, psd_plain):
                    per[name] = (energies(problem, EARLY), energies(problem, iterations))
            for name, (early, final) in per.items():
                line = dict(seed=int(seed), stage=stage, variant=name, batch=args.batch,
                            on=where,
                            early={k: float(np.median(v)) for k, v in early.items()},
                            final={k: float(np.median(v)) for k, v in final.items()})
                line["early_gap"] = gap(line["early"], jax_early)
                line["final_gap"] = gap(line["final"], jax_final)
                if "plain K1, K2+K3" in per:
                    p_early, p_final = per["plain K1, K2+K3"]
                    line["early_element_gap"] = float(np.median(
                        np.abs(early["total"] - p_early["total"]) / p_early["total"]))
                    line["final_element_gap"] = float(np.median(
                        np.abs(final["total"] - p_final["total"]) / p_final["total"]))
                print(json.dumps(line), flush=True)
                out.append(line)
    for variant in dict.fromkeys(line["variant"] for line in out):
        rows = [line for line in out if line["variant"] == variant]
        print(f"{variant}: largest gap to JAX CPU over {len(runs)} seeds, LM {EARLY} "
              f"{max(r['early_gap'] for r in rows):.4f}, LM {FINAL} "
              f"{max(r['final_gap'] for r in rows):.4f} ({where})")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
