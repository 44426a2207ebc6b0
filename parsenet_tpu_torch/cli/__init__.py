"""The port's entry points, one module per root script of the repository:
generate_predictions, test, test_open_splines, test_closed_control_points
and the four trainers. Each runs as

    python -m parsenet_tpu_torch.cli.<name> <config> [...] [--device cpu]

on the CUDA card by default (without one it raises), and each splits its
work into functions that take arrays, weights and draws (predict_split,
evaluate_split, evaluate_splinenet) from a `main(argv)` that reads files.
"""
