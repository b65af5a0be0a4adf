#!/bin/bash
# The canonical published configuration (reference sample_run.sh:3), on the
# PyTorch port's launcher. Arguments, if any, go on to the launcher after
# the canonical ones (e.g. --data-root DIR --max-updates N); with none the
# launcher gets the reference's argv.
bash "$(dirname "$0")/run_train.sh" 8 4 5 2 2 0 "$@"
