"""Two-stream shipping gate for params/ candidates (the port's counterpart
of scripts/promote_candidate.py, with the same checks, options and exit
codes).

A candidate's npz is copied into params/ only when both hold:
  1. stream a (the bench's historical gate): the quality floors applied
     and met, and seg_iou >= the shipped headline;
  2. stream b (a disjoint seed): seg_iou and sk_2 within --noise (0.02 by
     default) of the SHIPPED weights measured on the same stream b.
Each gate JSON is one bench record at the full 10k protocol: the port's
`python -m parsenet_tpu_torch.cli.bench` line (metric
torch_abc_shapes_per_hour_e2e; BENCH_PARAMS=<npz> [BENCH_STREAM=b]), the
JAX package's bench.py line, or a wrapped BENCH_r*.json ({"parsed": ...}).

    python -m parsenet_tpu_torch.cli.promote_candidate \
        --cand logs/cand_e2e.npz --gate-a logs/cand_a.json \
        --gate-b logs/cand_b.json --shipped-b logs/shipped_b.json \
        --shipped-a-json logs/shipped_a.json \
        [--cand-spline-prefix logs/cand_] [--noise 0.02] \
        [--dest params/parsenet_e2e.npz] [--params-dir params] [--bank DIR]

--cand-spline-prefix ships the candidate's own decoders with it
({prefix}{open,closed}_splinenet.npz into --params-dir), all three files
checked before any is copied; the gate JSONs' spline_src must then name a
checkpoint directory, and without the option "params". --bank copies the
three gate JSONs into DIR whatever the verdict.

Exit 0 = promoted (files copied); 1 = gate failed (nothing copied);
2 = inputs missing or unreadable. params/ is written by a green gate only.
"""
import argparse
import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def load_detail(path):
    """The detail dict of a bench JSON (a raw bench line or a wrapped
    BENCH_r*.json, {"parsed": {...}}), with the record's value."""
    with open(path) as f:
        data = json.load(f)
    if "parsed" in data:
        data = data["parsed"]
    if "detail" not in data:
        raise ValueError(f"{path}: no bench detail")
    d = dict(data["detail"])
    d["value"] = data.get("value", 0.0)
    if "error" in d:
        raise ValueError(f"{path}: bench errored: {d['error']}")
    return d


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Promote a candidate e2e export past the two-stream "
                    "gate.")
    ap.add_argument("--cand", required=True, help="candidate npz")
    ap.add_argument("--gate-a", required=True,
                    help="bench JSON: candidate on stream a (10k, floors)")
    ap.add_argument("--gate-b", required=True,
                    help="bench JSON: candidate on stream b")
    ap.add_argument("--shipped-b", required=True,
                    help="bench JSON: SHIPPED params on stream b")
    ap.add_argument("--shipped-a-json", default="",
                    help="bench JSON for the shipped params on stream a "
                         "(a cli.bench line or a BENCH_r*.json); its seg_iou "
                         "is the headline the candidate must meet")
    ap.add_argument("--shipped-a-seg-iou", type=float, default=None,
                    help="explicit headline override when no JSON exists")
    ap.add_argument("--noise", type=float, default=0.02)
    ap.add_argument("--dest", default=os.path.join(REPO, "params",
                                                   "parsenet_e2e.npz"))
    ap.add_argument("--cand-spline-prefix", default="",
                    help="promote the candidate's OWN SplineNet decoders "
                         "(<prefix>{open,closed}_splinenet.npz) alongside "
                         "the e2e npz — required when the gate ran with "
                         "BENCH_SPLINE_DIR (atomic bundle promotion)")
    ap.add_argument("--params-dir", default=os.path.join(REPO, "params"),
                    help="where bundle decoders are shipped (tests only; "
                         "the real gate always ships to params/)")
    ap.add_argument("--bank", default="",
                    help="directory to copy the three gate JSONs into "
                         "(e.g. artifacts/) so the promotion run banks its "
                         "own evidence")
    args = ap.parse_args(argv)

    try:
        a = load_detail(args.gate_a)
        b = load_detail(args.gate_b)
        sb = load_detail(args.shipped_b)
    except (OSError, ValueError, KeyError) as e:
        print(f"promote: cannot evaluate gate: {e}", file=sys.stderr)
        raise SystemExit(2)
    if args.shipped_a_seg_iou is not None:
        shipped_a_iou = args.shipped_a_seg_iou
    elif args.shipped_a_json:
        try:
            shipped_a_iou = load_detail(args.shipped_a_json)["seg_iou"]
        except (OSError, ValueError, KeyError) as e:
            print(f"promote: cannot read shipped-a headline: {e}",
                  file=sys.stderr)
            raise SystemExit(2)
    else:
        print("promote: need --shipped-a-json or --shipped-a-seg-iou",
              file=sys.stderr)
        raise SystemExit(2)
    if not os.path.exists(args.cand):
        print(f"promote: candidate {args.cand} missing", file=sys.stderr)
        raise SystemExit(2)
    # Bundle promotion: every file must exist BEFORE any is copied, so a
    # half-missing bundle can never leave params/ in a mixed state.
    spline_srcs = []
    if args.cand_spline_prefix:
        for name in ("open_splinenet", "closed_splinenet"):
            p = f"{args.cand_spline_prefix}{name}.npz"
            if not os.path.exists(p):
                print(f"promote: bundle decoder {p} missing", file=sys.stderr)
                raise SystemExit(2)
            spline_srcs.append((p, os.path.join(args.params_dir,
                                                f"{name}.npz")))

    if args.bank:
        os.makedirs(args.bank, exist_ok=True)
        for src in (args.gate_a, args.gate_b, args.shipped_b):
            dst = os.path.join(args.bank, os.path.basename(src))
            if os.path.abspath(src) != os.path.abspath(dst):
                shutil.copyfile(src, dst)
        print(f"promote: banked gate artifacts -> {args.bank}")

    checks = [
        ("stream-a measured at 10k", a.get("num_points") == 10000),
        ("stream-a is stream a", a.get("stream", "a") == "a"),
        ("stream-a trained params", bool(a.get("trained_params"))),
        # quality_ok is vacuously true when bench didn't evaluate floors
        # (ablated/reduced runs set floors_applied=false); the gate must see
        # floors actually applied, and never accept an ablated pipeline
        # (BENCH_ABLATE stubs stages — e.g. ablate=ms records seg_iou 1.0).
        # Old artifacts predate both fields and default to full/applied.
        ("stream-a floors actually applied",
         bool(a.get("floors_applied", True))),
        ("no stage ablated (a/b/shipped-b)",
         not a.get("ablate") and not b.get("ablate") and not sb.get("ablate")),
        ("stream-a floors green", bool(a.get("quality_ok"))),
        (f"stream-a seg_iou {a['seg_iou']:.4f} >= shipped "
         f"{shipped_a_iou:.4f}", a["seg_iou"] >= shipped_a_iou),
        ("stream-b is stream b", b.get("stream") == "b"
         and sb.get("stream") == "b"),
        # the stream-b arms must be the SAME full-scale trained protocol as
        # stream a — a reduced-scale or untrained-params b-measurement would
        # silently satisfy the noise band
        ("stream-b measured at 10k", b.get("num_points") == 10000
         and sb.get("num_points") == 10000),
        ("stream-b trained params", bool(b.get("trained_params"))
         and bool(sb.get("trained_params"))),
        (f"stream-b seg_iou {b['seg_iou']:.4f} >= shipped-b "
         f"{sb['seg_iou']:.4f} - {args.noise}",
         b["seg_iou"] >= sb["seg_iou"] - args.noise),
        (f"stream-b sk_2 {b['sk_2']:.4f} >= shipped-b {sb['sk_2']:.4f} "
         f"- {args.noise}", b["sk_2"] >= sb["sk_2"] - args.noise),
    ]
    # Decoder-consistency: if the gate artifacts record which SplineNet
    # source they measured with (the bench's "spline_src"), the
    # promotion mode must match — candidate-decoder gates ("<dir>/checkpoints")
    # require bundle promotion, shipped-decoder gates ("params") forbid it.
    # Old artifacts without the field skip this check.
    for label, det in (("gate-a", a), ("gate-b", b)):
        src = det.get("spline_src")
        if src is None:
            continue
        if args.cand_spline_prefix:
            # must be a real checkpoint dir — "params" means shipped
            # decoders, "random" means NO decoders were restorable (the
            # gate measured randomly initialized SplineNets)
            checks.append((f"{label} measured with candidate decoders "
                           f"(spline_src={src})",
                           src.endswith("/checkpoints")))
        else:
            checks.append((f"{label} measured with shipped decoders "
                           f"(spline_src={src})", src == "params"))

    ok = True
    for name, passed in checks:
        print(f"promote: [{'PASS' if passed else 'FAIL'}] {name}")
        ok = ok and passed
    if not ok:
        print("promote: GATE FAILED — params/ untouched", file=sys.stderr)
        raise SystemExit(1)
    for src, dst in spline_srcs:
        shutil.copyfile(src, dst)
        print(f"promote: PROMOTED decoder {src} -> {dst}")
    shutil.copyfile(args.cand, args.dest)
    print(f"promote: PROMOTED {args.cand} -> {args.dest} "
          f"(seg_iou {a['seg_iou']:.4f}, stream-b seg_iou {b['seg_iou']:.4f})")


if __name__ == "__main__":
    main()
