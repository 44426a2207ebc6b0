"""The port's entry points, one module per root script of the repository
(generate_predictions, test, test_open_splines, test_closed_control_points,
the four trainers, the benches) and per script of the route from training
to shipped weights (finetune_e2e, export_params, promote_candidate,
make_synthetic_data, train_workflow, validate_reference, fetch_dataset,
data_day_drill). Each runs as

    python -m parsenet_tpu_torch.cli.<name> [...] [--device cpu]

those that run a network on the CUDA card by default (without one they
raise), and each splits its work into functions that take arrays, weights
and draws (predict_split, evaluate_split, evaluate_splinenet,
validate_split, finetune) from a `main(argv)` that reads files.
"""
