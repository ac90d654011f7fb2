#!/bin/bash
# The PyTorch port's whole train -> eval -> reconstruction chain on a
# synthetic KITTI tree, in one command: the counterpart of
# scripts/run_eval_chain.sh. Every stage (the tree, train-kitti, the four
# eval commands, generate-novel-depths, depth2tsdf, eval-sr) runs as a
# subprocess through the port's click commands, each timed and summed, by
# scripts/smoke_eval_chain_torch.py, which takes the arguments given here:
#
#   scripts/run_eval_chain_torch.sh [--workdir DIR] [--device cuda:0]
set -u
cd "$(dirname "$0")/.."
python scripts/smoke_eval_chain_torch.py "$@"
rc=$?
echo "CHAIN SCRIPT DONE rc=$rc"
exit $rc
