#!/usr/bin/env bash
# CI for the PyTorch/CUDA port (src/repro_torch/); scripts/ci.sh runs the
# JAX package.  Stages: repo hygiene, the port's test suite (held against
# the JAX package on the CPU; the cuda-marked tests run where a card is),
# the fabric verifier, and the four ported example scripts at small sizes.
# Every stage runs on the card where CUDA is available and on the CPU
# (--device cpu) where it is not.
set -euo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"

if python -c "import sys, torch; sys.exit(0 if torch.cuda.is_available() else 1)"; then
  DEVICE=()
  echo "=== CUDA device found: the port runs on the card ==="
else
  DEVICE=(--device cpu)
  echo "=== no CUDA device: the port runs its plain PyTorch paths on the CPU ==="
fi

echo "=== repo hygiene (no tracked bytecode) ==="
if git ls-files | grep -E '(^|/)__pycache__/|\.pyc$'; then
  echo "ERROR: tracked Python bytecode found (see above); git rm --cached it" >&2
  exit 1
fi

echo "=== port test suite ==="
python -m pytest -q tests/test_torch_*.py

echo "=== fabric static analysis (the card check is a warning off the card) ==="
python -m repro_torch.analysis.lint -q "${DEVICE[@]}"

echo "=== example scripts ==="
python examples/quickstart_torch.py "${DEVICE[@]}"
python examples/multichip_snn_torch.py --steps 10 --batch 4 "${DEVICE[@]}"
python examples/serve_lm_torch.py --arch qwen3-8b "${DEVICE[@]}"
python examples/serve_lm_torch.py --arch rwkv6-7b "${DEVICE[@]}"
python examples/train_lm_torch.py --smoke --steps 20 --simulate-failure \
  "${DEVICE[@]}"

# === port benchmarks ===
# Reserved: the port's benchmarks (ROADMAP queue 1 item 3) run here once
# they exist, on the card only, writing their own GPU-stamped results.
