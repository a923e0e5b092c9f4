"""End-to-end marker-file pipeline CLI.

Mirror of the reference's process_markers_app
(momentum/examples/process_markers_app/process_markers_app.cpp:16 →
marker_tracking/process_markers.cpp:292 processMarkerFile), with the
options and printed lines of momentum_tpu's examples/process_markers.py:
  load character (+ model definition) → load markers (C3D/TRC) →
  calibrate identity → track per frame → save motion (GLB/MMO/BVH).

Everything runs on `--device`, the CUDA card by default. Without a card the
CLI exits non-zero unless `--device cpu` is given; it never carries on on
the CPU by itself.

Usage:
  python -m momentum_tpu_torch.tracking.process_markers_app --markers clip.c3d \\
      --character char.glb --out solved.glb [--calib-frames 60] [--max-iter 30] \\
      [--smoothing 0] [--device cpu]
"""

from __future__ import annotations

import argparse
import configparser
import dataclasses
import sys
import time


def parse_args(argv=None) -> argparse.Namespace:
    """The options, with an INI config's values as defaults (explicit flags
    win; the reference CLI's set_config("-c"), process_markers_app.cpp:19-51)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-c", "--config", help="INI config file with option defaults (the "
                    "reference CLI's set_config('-c'), process_markers_app.cpp:19-51)")
    ap.add_argument("--markers", required=True, help="C3D or TRC marker file")
    ap.add_argument("--character", required=True,
                    help="GLB, FBX, URDF or USDA character file, or the literal 'cmu' to "
                    "bootstrap the built-in CMU/Vicon 41-marker humanoid (tracking/cmu.py)")
    ap.add_argument("--model", help="optional .model/.cfg parameter definition")
    ap.add_argument("--out", required=True, help="output .glb/.mmo/.bvh motion")
    ap.add_argument("--calib-frames", type=int, default=60)
    ap.add_argument("--major-iter", type=int, default=2)
    ap.add_argument("--max-iter", type=int, default=30)
    ap.add_argument("--smoothing", type=float, default=0.0)
    ap.add_argument("--no-calibrate", action="store_true")
    ap.add_argument("--method", default=None,
                    help="per-frame solver: gauss_newton (default) or levenberg_marquardt "
                    "(robust on uncalibrated rigs)")
    ap.add_argument("--calibrate-locators", action="store_true",
                    help="also refine locator offsets against the clip (calibrateLocators "
                    "alternation)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the pipeline runs on (default: the CUDA card)")
    pre, _ = ap.parse_known_args(argv)
    if getattr(pre, "config", None):
        cp = configparser.ConfigParser()
        cp.read(pre.config)
        defaults = dict(cp.defaults())
        for sec in cp.sections():
            defaults.update(dict(cp[sec]))
        known = {a.dest for a in ap._actions}
        ap.set_defaults(**{k.replace("-", "_"): v for k, v in defaults.items()
                           if k.replace("-", "_") in known})
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import numpy as np
    import torch

    import momentum_tpu_torch.io as mio
    from momentum_tpu_torch.device import resolve
    from momentum_tpu_torch.tracking import (
        CalibrationConfig, TrackingConfig, calibrate_model, track_poses_per_frame,
        track_sequence)
    from momentum_tpu_torch.tracking.app_utils import load_character

    device = resolve(args.device, "process_markers_app")
    t0 = time.time()
    bootstrap_cmu = args.character.lower() == "cmu"
    if bootstrap_cmu:
        from momentum_tpu_torch.tracking.cmu import create_cmu_character

        character = create_cmu_character(device=device)
        if args.method is None:
            args.method = "levenberg_marquardt"  # cold-start robustness
    else:
        character = load_character(args.character, device=device)
    method = args.method or "gauss_newton"
    if args.model:
        pt, limits = mio.load_model_definition(args.model, character.skeleton)
        character = dataclasses.replace(character, parameter_transform=pt, limits=limits)
    print(f"character: {character.num_joints} joints, "
          f"{character.num_model_parameters} parameters")

    if args.markers.lower().endswith(".trc"):
        raw = mio.load_trc(args.markers)
    else:
        raw = mio.load_c3d(args.markers)
    markers = raw.to_marker_sequence(device=device)
    print(f"markers: {markers.num_frames} frames × {markers.num_markers} markers "
          f"@ {raw.fps:g} fps")

    identity = torch.zeros(character.num_model_parameters, device=device)
    if bootstrap_cmu:
        # seed the free root translation at the first frame's marker centroid
        identity[:3] = torch.nanmean(markers.positions[0], dim=0)
    if not args.no_calibrate:
        cfg = CalibrationConfig(calib_frames=args.calib_frames, major_iter=args.major_iter,
                                max_iter=args.max_iter, method=method,
                                regularization=1e-3 if bootstrap_cmu else 0.05)
        # the returned identity includes the initial seed with the universal
        # (scale) entries replaced by their calibrated values
        identity, _ = calibrate_model(character, markers, cfg, initial=identity)
        print(f"calibrated identity: |θ_id| = {float(torch.linalg.norm(identity)):.4f}")
        if args.calibrate_locators or bootstrap_cmu:
            cfg_loc = dataclasses.replace(cfg, locators_only=True,
                                          major_iter=max(1, args.major_iter - 1))
            _, _, character = calibrate_model(character, markers, cfg_loc, initial=identity)
            print("locator offsets refined against the clip")

    tcfg = TrackingConfig(max_iter=args.max_iter, smoothing=args.smoothing, method=method,
                          regularization=1e-3 if bootstrap_cmu else 0.05)
    if args.smoothing > 0:
        result, _ = track_sequence(character, markers, tcfg, initial=None)
    else:
        result = track_poses_per_frame(character, markers, tcfg, initial=identity)
    med = float(np.median(result.errors.cpu().numpy()))
    print(f"tracked {markers.num_frames} frames, median residual {med:.3e} "
          f"({time.time() - t0:.1f}s total)")

    motion = result.motion
    if args.out.endswith(".glb"):
        mio.save_character_glb(args.out, character, motion=motion, fps=raw.fps)
    elif args.out.endswith(".mmo"):
        mio.save_mmo(args.out, motion, np.zeros(character.num_joints, np.float32),
                     list(character.parameter_transform.names),
                     list(character.skeleton.joint_names))
    elif args.out.endswith(".bvh"):
        mio.save_bvh(args.out, character, character.parameter_transform.apply(motion),
                     fps=raw.fps)
    else:
        raise SystemExit(f"unknown output format: {args.out}")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    sys.exit(main())
