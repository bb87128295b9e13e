#!/bin/bash
# Two trees of this repository on one CUDA card in one call, in turns:
# parent, change, change, parent. Each turn runs tools/profile_torch_p1.py
# (Profile 1) and tools/profile_torch_p1.py --p2 (Profile 2, float64) of that
# tree, each tree's own copy, so walls, launches per call and device busy of
# the two are read side by side under one power limit.
#
#   git archive <parent commit> | tar -x -C <dir>     # the parent's tree
#   bash tools/profile_ab.sh <dir> [out dir]          # from the change's root
#
# Logs go to <out dir> (default _profile/ab); the wall, launches and device
# lines of all eight runs are printed at the end.
set -u
parent=${1:?usage: profile_ab.sh <parent tree> [out dir]}
out=$(mkdir -p "${2:-_profile/ab}" && cd "${2:-_profile/ab}" && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
turn() {  # tree, label
    for mode in "" "--p2"; do
        log="$out/$2_$([ -z "$mode" ] && echo p1 || echo p2).log"
        (cd "$1" && python3 tools/profile_torch_p1.py $mode) > "$log" 2>&1
        echo "rc=$?" >> "$log"
    done
}
turn "$parent" parent1
turn . change1
turn . change2
turn "$parent" parent2
for label in parent1 change1 change2 parent2; do
    echo "== $label"
    grep -h "^wall\|^launches\|^device\|^rc=" "$out/${label}_p1.log" "$out/${label}_p2.log" | cut -c1-200
done
