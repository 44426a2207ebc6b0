"""Write synthetic stand-in datasets in the reference's h5 schema (the
port's counterpart of scripts/make_synthetic_data.py): ABC-like segment
shapes for the segmentation and e2e trainers and the test protocol, and
spline patches for the SplineNet trainers (data.synthetic.write_abc_h5 /
write_spline_h5, the arrays of the JAX package's writers bit for bit).

    python -m parsenet_tpu_torch.cli.make_synthetic_data [--shapes 256] \\
        [--splines 512] [--points 10000] [--out data]

Writes {out}/shapes/{train,val,test}_data.h5 (seeds 0, 1, 2; val and test
hold shapes // 6 shapes, at least 8) and {out}/spline/
{open,closed}_splines.h5 (700 points, seeds 3 and 4). Needs h5py.
"""
import argparse

from ..data.synthetic import write_abc_h5, write_spline_h5


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Write synthetic ABC-format and spline h5 datasets.")
    ap.add_argument("--shapes", type=int, default=256)
    ap.add_argument("--splines", type=int, default=512)
    ap.add_argument("--points", type=int, default=10000)
    ap.add_argument("--out", default="data")
    args = ap.parse_args(argv)
    for split, n, seed in (("train", args.shapes, 0),
                           ("val", max(args.shapes // 6, 8), 1),
                           ("test", max(args.shapes // 6, 8), 2)):
        path = f"{args.out}/shapes/{split}_data.h5"
        write_abc_h5(path, n, num_points=args.points, seed=seed)
        print("wrote", path)
    write_spline_h5(f"{args.out}/spline/open_splines.h5", args.splines,
                    num_points=700, seed=3)
    write_spline_h5(f"{args.out}/spline/closed_splines.h5", args.splines,
                    num_points=700, closed=True, seed=4)
    print("wrote spline h5s")


if __name__ == "__main__":
    main()
