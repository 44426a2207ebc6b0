#!/bin/bash
# Run the port's bench entry points as a user calls them, on one CUDA card,
# from the repository root:
#   bash scripts/torch_cli_benches.sh
# cli.bench on stream a (bf16 and f32 mean-shift) and stream b,
# cli.bench_train all and e2e_ablate, then BENCH_SHARD=1, which must be
# refused. Prints the card line and each command's exit code; the JSON
# lines go to chiprun_out/cli_bench*.jsonl and are printed at the end.
set -u
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
mkdir -p chiprun_out
python -m parsenet_tpu_torch.cli.bench > chiprun_out/cli_bench.jsonl
echo "bench exit=$?"
BENCH_MS_BF16=0 python -m parsenet_tpu_torch.cli.bench \
    >> chiprun_out/cli_bench.jsonl
echo "bench f32 mean-shift exit=$?"
BENCH_STREAM=b python -m parsenet_tpu_torch.cli.bench \
    >> chiprun_out/cli_bench.jsonl
echo "bench stream b exit=$?"
python -m parsenet_tpu_torch.cli.bench_train all \
    > chiprun_out/cli_bench_train.jsonl
echo "bench_train all exit=$?"
python -m parsenet_tpu_torch.cli.bench_train e2e_ablate \
    >> chiprun_out/cli_bench_train.jsonl
echo "bench_train e2e_ablate exit=$?"
BENCH_SHARD=1 python -m parsenet_tpu_torch.cli.bench 2>&1 | tail -1
echo "bench BENCH_SHARD=1 exit=${PIPESTATUS[0]} (refused: 1)"
cat chiprun_out/cli_bench.jsonl chiprun_out/cli_bench_train.jsonl
