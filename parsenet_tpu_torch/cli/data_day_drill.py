"""The real-data drill without a network (the port's counterpart of
scripts/data_day_drill.py): the whole chain from a download to the parity
table runs on a local fixture laid out as the reference's download.

    fetch (file:// fixture) -> sha256 pins -> unzip into the repository
    layout -> schema check (cli.fetch_dataset) -> the two-stage protocol
    and its parity table (cli.validate_reference, with --params
    params/parsenet_e2e.npz, the shipped weights)

The fixture is a data.zip (data/shapes/{train,val,test}_data.h5,
data/spline/{open,closed}_splines.h5 from data.synthetic's writers) and a
predictions.h5. With the real data, --source and the pins change and
nothing downstream does.

    python -m parsenet_tpu_torch.cli.data_day_drill [--workdir DIR] \\
        [--points 2048] [--shapes 12] [--eval-shapes 2] [--keep] \\
        [--device cuda]

The workdir defaults to data_day_drill under the system's temporary
directory and is removed afterwards unless --keep. Needs h5py. Exit 0 =
the chain is green (fetch, schema and the parity table); otherwise it
exits 1 with the failing step.
"""
import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import zipfile

from ..core.guards import entry_device
from ..data.synthetic import write_abc_h5, write_spline_h5
from . import validate_reference
from .fetch_dataset import sha256

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FETCHED = ("data/shapes/train_data.h5", "data/shapes/val_data.h5",
           "data/shapes/test_data.h5", "data/spline/open_splines.h5",
           "data/spline/closed_splines.h5", "logs/predictions.h5")


def build_fixture(serve_dir: str, points: int, shapes: int) -> dict:
    """data.zip and predictions.h5 in the reference download's layout
    under serve_dir -> {file name: sha256}."""
    import h5py
    import numpy as np

    stage = os.path.join(serve_dir, "_stage")
    for split, n, seed in (("train", shapes, 0), ("val", shapes, 1),
                           ("test", shapes, 2)):
        write_abc_h5(os.path.join(stage, "data", "shapes",
                                  f"{split}_data.h5"),
                     n, num_points=points, seed=seed)
    for fam, closed in (("open", False), ("closed", True)):
        write_spline_h5(os.path.join(stage, "data", "spline",
                                     f"{fam}_splines.h5"),
                        8, num_points=700, closed=closed, seed=3 + closed)
    zpath = os.path.join(serve_dir, "data.zip")
    with zipfile.ZipFile(zpath, "w") as z:
        for root, _, files in os.walk(os.path.join(stage, "data")):
            for f in files:
                full = os.path.join(root, f)
                z.write(full, os.path.relpath(full, stage))
    # the reference also serves precomputed stage-1 predictions
    with h5py.File(os.path.join(serve_dir, "predictions.h5"), "w") as f:
        f.create_dataset("seg_id", data=np.zeros((shapes, points), "i4"))
        f.create_dataset("pred_primitives",
                         data=np.zeros((shapes, points), "i4"))
    shutil.rmtree(stage)
    return {name: sha256(os.path.join(serve_dir, name))
            for name in ("data.zip", "predictions.h5")}


def drill_config(path: str, dest: str, points: int, shapes: int) -> str:
    """The eval config of the fetched tree (mode 5, k 80)."""
    with open(path, "w") as f:
        f.write(f"""# data-day drill eval config (generated)
[train]
model_path = "parsenet_e2e"
dataset = "{dest}/data/shapes/"
log_dir = "{os.path.dirname(path)}/logs"
normals = True
num_train = 0
num_val = {shapes}
num_test = {shapes}
num_points = {points}
grid_size = 20
batch_size = 1
mode = 5
knn_k = 80
""")
    return path


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="Fetch a local fixture and run the parity protocol.")
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(),
                                                      "data_day_drill"))
    ap.add_argument("--points", type=int, default=2048)
    ap.add_argument("--shapes", type=int, default=12)
    ap.add_argument("--eval-shapes", type=int, default=2)
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device of the protocol (default cuda)")
    args = ap.parse_args(argv)
    entry_device(args.device)

    wd = os.path.abspath(args.workdir)
    if os.path.exists(wd):
        shutil.rmtree(wd)
    serve, dest = os.path.join(wd, "serve"), os.path.join(wd, "dest")
    os.makedirs(serve)
    os.makedirs(dest)

    print("drill: building file:// fixture", flush=True)
    pins = build_fixture(serve, args.points, args.shapes)

    print("drill: fetch + sha256 + unzip + schema validation", flush=True)
    r = subprocess.run(
        [sys.executable, "-m", "parsenet_tpu_torch.cli.fetch_dataset",
         "--source", f"file://{serve}", "--dest", dest,
         "--num-points", str(args.points)]
        + [x for n, h in pins.items() for x in ("--sha256", f"{n}={h}")],
        cwd=REPO)
    if r.returncode != 0:
        sys.exit(f"drill: fetch/schema FAILED rc={r.returncode}")
    for rel in FETCHED:
        if not os.path.exists(os.path.join(dest, rel)):
            sys.exit(f"drill: fetched tree missing {rel}")

    print("drill: parity protocol on the fetched data (shipped params)",
          flush=True)
    cfg = drill_config(os.path.join(wd, "config_drill.yml"), dest,
                       args.points, args.shapes)
    argv_v = [cfg, "--params", os.path.join(REPO, "params",
                                            "parsenet_e2e.npz"),
              "--num-shapes", str(args.eval_shapes)]
    if args.device:
        argv_v += ["--device", args.device]
    summary = validate_reference.main(argv_v)
    if summary.get("n_shapes") != args.eval_shapes:
        sys.exit(f"drill: validate_reference evaluated "
                 f"{summary.get('n_shapes')} shapes, not "
                 f"{args.eval_shapes}")
    print(f"drill: GREEN - fetch->sha256->schema->parity chain complete "
          f"({summary['n_shapes']} shapes evaluated)", flush=True)
    if not args.keep:
        shutil.rmtree(wd)
    return summary


if __name__ == "__main__":
    main()
