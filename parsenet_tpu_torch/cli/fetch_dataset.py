"""Fetch the ParSeNet datasets into the repository's layout and check
their schema (the port's counterpart of scripts/fetch_dataset.py, which
cli.data_day_drill drives).

    python -m parsenet_tpu_torch.cli.fetch_dataset [--source URL_BASE] \
        [--dest .] [--validate-only] [--num-points 10000] \
        [--sha256 FILE=HEX ...]

Downloads {source}/data.zip and {source}/predictions.h5 (resuming a
partial file), checks the optional sha256 pins, unpacks data/shapes/
{train,val,test}_data.h5 and data/spline/{open,closed}_splines.h5 from the
zip and moves predictions.h5 to logs/, then checks every h5 against the
schema the readers expect (data.abc, data.splines): dataset names, dtype
kinds, the trailing 3 and the points a shape. A file:// source needs no
network. Exit 0 when the schema holds, 1 when it does not.
"""
import argparse
import hashlib
import os
import sys
import urllib.request
import zipfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_SOURCE = "http://neghvar.cs.umass.edu/public_data/parsenet"
FILES = ("data.zip", "predictions.h5")

# the h5 schemas (reference src/dataset_segments.py:38-69,
# src/dataset.py:50-52)
SHAPE_KEYS = {"points": ("f", 3), "labels": ("i", None),
              "normals": ("f", 3), "prim": ("i", None)}
SPLINE_KEYS = {"points": ("f", 3), "controlpoints": ("f", 3)}


def fetch(url: str, dest: str) -> None:
    """Resumable download: continues a partial file via HTTP Range."""
    part = dest + ".part"
    have = os.path.getsize(part) if os.path.exists(part) else 0
    req = urllib.request.Request(url)
    if have:
        req.add_header("Range", f"bytes={have}-")
    print(f"fetch {url} -> {dest} (resume at {have})", flush=True)
    with urllib.request.urlopen(req, timeout=60) as r:
        mode = "ab" if have and r.status == 206 else "wb"
        with open(part, mode) as f:
            while True:
                chunk = r.read(1 << 20)
                if not chunk:
                    break
                f.write(chunk)
    os.replace(part, dest)


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _check_h5(path: str, keys: dict, n_points: int = None) -> list:
    problems = []
    try:
        import h5py
    except ImportError:
        return [f"{path}: h5py unavailable"]
    if not os.path.exists(path):
        return [f"{path}: missing"]
    with h5py.File(path, "r") as f:
        for k, (kind, last_dim) in keys.items():
            if k not in f:
                problems.append(f"{path}: missing key '{k}'")
                continue
            d = f[k]
            if d.dtype.kind != kind:
                problems.append(f"{path}/{k}: dtype kind {d.dtype.kind} != "
                                f"{kind}")
            if last_dim is not None and d.shape[-1] != last_dim:
                problems.append(f"{path}/{k}: last dim {d.shape[-1]} != "
                                f"{last_dim}")
            if n_points is not None and len(d.shape) > 1 \
                    and d.shape[1] != n_points:
                problems.append(f"{path}/{k}: expected {n_points} points, "
                                f"got {d.shape[1]}")
    return problems


def validate(dest: str, n_points: int = 10000) -> int:
    problems = []
    for split in ("train", "val", "test"):
        problems += _check_h5(
            os.path.join(dest, "data", "shapes", f"{split}_data.h5"),
            SHAPE_KEYS, n_points=n_points)
    for fam in ("open", "closed"):
        problems += _check_h5(
            os.path.join(dest, "data", "spline", f"{fam}_splines.h5"),
            SPLINE_KEYS)
    for p in problems:
        print("SCHEMA:", p)
    print("schema OK" if not problems else f"{len(problems)} problem(s)")
    return 1 if problems else 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Fetch the datasets and check their schema.")
    ap.add_argument("--source", default=DEFAULT_SOURCE)
    ap.add_argument("--dest", default=REPO)
    ap.add_argument("--validate-only", action="store_true")
    ap.add_argument("--num-points", type=int, default=10000,
                    help="expected points per shape (the real ABC protocol "
                         "is 10000; reduced-scale drills override)")
    ap.add_argument("--sha256", action="append", default=[],
                    metavar="FILE=HEX",
                    help="optional integrity pins, e.g. data.zip=abc123...")
    args = ap.parse_args(argv)
    if args.validate_only:
        sys.exit(validate(args.dest, args.num_points))

    pins = dict(s.split("=", 1) for s in args.sha256)
    os.makedirs(os.path.join(args.dest, "logs"), exist_ok=True)
    for name in FILES:
        out = os.path.join(args.dest, name)
        if not os.path.exists(out):
            fetch(f"{args.source}/{name}", out)
        if name in pins and sha256(out) != pins[name].lower():
            sys.exit(f"{name}: sha256 mismatch")
    zpath = os.path.join(args.dest, "data.zip")
    with zipfile.ZipFile(zpath) as z:
        members = [m for m in z.namelist()
                   if m.startswith("data/") and not m.endswith("/")]
        z.extractall(args.dest, members)
        print(f"extracted {len(members)} files from data.zip")
    os.replace(os.path.join(args.dest, "predictions.h5"),
               os.path.join(args.dest, "logs", "predictions.h5"))
    sys.exit(validate(args.dest, args.num_points))


if __name__ == "__main__":
    main()
