#!/bin/bash
# Two trees of this repository on one CUDA card in one call, in turns:
# parent, change, change, parent. Each turn runs this tree's
# tools/profile_torch_p1.py in three modes (Profile 1; --p2, Profile 2 and
# float64; --lossless, profiles 0 and 4 with the s32le Encoder) on that
# turn's tree (FRAD_PROFILE_TREE), so walls, launches per
# call, device busy and the outputs' digests of the two are read side by
# side under one power limit.
#
#   git archive <parent commit> | tar -x -C <dir>     # the parent's tree
#   bash tools/profile_ab.sh <dir> [out dir]          # from the change's root
#
# AB_MODES (default "p1 p2 lossless") picks the modes, e.g. AB_MODES=p2.
#
# Logs go to <out dir> (default _profile/ab); the wall, launches, device and
# digest lines of all runs are printed at the end.
set -u
parent=$(cd "${1:?usage: profile_ab.sh <parent tree> [out dir]}" && pwd)
out=$(mkdir -p "${2:-_profile/ab}" && cd "${2:-_profile/ab}" && pwd)
modes=${AB_MODES:-p1 p2 lossless}
tool=$(pwd)/tools/profile_torch_p1.py
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
turn() {  # tree, label
    for mode in $modes; do
        flag=$([ "$mode" = p1 ] || echo "--$mode")
        (cd "$1" && FRAD_PROFILE_TREE="$1" python3 "$tool" $flag) > "$out/$2_$mode.log" 2>&1
        echo "rc=$?" >> "$out/$2_$mode.log"
    done
}
turn "$parent" parent1
turn "$(pwd)" change1
turn "$(pwd)" change2
turn "$parent" parent2
for label in parent1 change1 change2 parent2; do
    echo "== $label"
    for mode in $modes; do
        grep -h "^wall\|^launches\|^device\|^digest\|^rc=" "$out/${label}_$mode.log" | cut -c1-200
    done
done
