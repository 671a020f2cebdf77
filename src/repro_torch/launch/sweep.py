"""The dry-run sweep: one subprocess per (arch x shape x mesh) cell.
Counterpart of `repro.launch.sweep`.

Per-cell isolation keeps one failed trace from killing the sweep and
bounds memory growth.  Single-pod cells run with differential cost probes
(they feed the roofline table); multi-pod cells trace the full-depth step
and its memory only.  Each cell is ``python -m repro_torch.launch.dryrun``
(`launch.dryrun`: rank 0's step on a fake process group, meta tensors, no
card); its record goes to ``build/dryrun/``.  A cell is counted ``ok``
or ``FAIL`` by the process's exit code, as in the reference, but one
whose record says ``skipped`` (a cell the port cannot form, ``not in
the port:``) is counted and printed as skipped.

  PYTHONPATH=src python -m repro_torch.launch.sweep --mesh single
  PYTHONPATH=src python -m repro_torch.launch.sweep --mesh both
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import repro_torch.configs as configs
from repro_torch.configs.shapes import SHAPES, applicable
from repro_torch.launch.dryrun import ARTIFACTS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--force", action="store_true",
                    help="re-run cells that already have ok artifacts")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = []
    for mesh in meshes:
        for arch in configs.list_archs():
            for shape in SHAPES:
                cells.append((arch, shape, mesh))

    done = failed = skipped = 0
    for arch, shape, mesh in cells:
        tag = f"{arch}__{shape}__{mesh}"
        art = ARTIFACTS / f"{tag}.json"
        cfg = configs.get(arch)
        ok, reason = applicable(cfg, SHAPES[shape])
        if not ok:
            ARTIFACTS.mkdir(parents=True, exist_ok=True)
            art.write_text(json.dumps({
                "arch": arch, "shape": shape, "mesh": mesh,
                "status": "skipped", "reason": reason}, indent=2))
            skipped += 1
            print(f"[skip] {tag}: {reason}", flush=True)
            continue
        if art.exists() and not args.force:
            try:
                prev = json.loads(art.read_text())
                if prev.get("status") == "ok" and (
                        mesh == "multi" or "extrapolated" in prev):
                    done += 1
                    print(f"[cached] {tag}", flush=True)
                    continue
            except Exception:
                pass
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--mesh", mesh,
               "--out", str(ARTIFACTS)]
        if mesh == "multi":
            cmd.append("--no-probes")
        t0 = time.time()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=args.timeout)
            rc = proc.returncode
        except subprocess.TimeoutExpired:
            rc = -9
        dt = time.time() - t0
        if rc != 0:
            failed += 1
            ARTIFACTS.mkdir(parents=True, exist_ok=True)
            if not art.exists():
                art.write_text(json.dumps({
                    "arch": arch, "shape": shape, "mesh": mesh,
                    "status": "error",
                    "error": f"subprocess rc={rc}"}, indent=2))
            print(f"[FAIL] {tag} ({dt:.0f}s)", flush=True)
            continue
        rec = json.loads(art.read_text()) if art.exists() else {}
        if rec.get("status") == "skipped":   # a cell not in the port
            skipped += 1
            print(f"[skip] {tag}: {rec['reason']}", flush=True)
        else:
            done += 1
            print(f"[ok] {tag} ({dt:.0f}s)", flush=True)
    print(f"sweep complete: ok={done} failed={failed} skipped={skipped}",
          flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
