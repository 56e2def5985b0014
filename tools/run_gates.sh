#!/bin/sh
# Full verification ladder (reference analogue: .travis.yml:7-21), on CPU.
#   1. fast unit tier
#   2. golden nightly tier
# The GPU path is checked by `python chip_smoke.py` on the card.
set -e
cd "$(dirname "$0")/.."
JAX_PLATFORMS=cpu python -m pytest tests/ -q
JAX_PLATFORMS=cpu python -m pytest tests/ -q -m golden
