#!/bin/sh
# The port's accuracy record on one card: the round-4 headline
# (accuracy_bench walk_xyz F=4, 100 frames, seeds 0-2) and the four
# r5_suite groups, each row written under the JAX evidence's file name,
# then check_closures over every corridor run with loop closure on.
#
#   sh accuracy_torch/record.sh [OUT_DIR]     (default: accuracy_torch/)
#
# The sequences are rendered first, all at once, into $SF_ADV_CACHE
# (default /tmp/sf_adv_cache; the 1500-frame corridor in the background),
# then the five jobs run side by side on the card, each in a process of
# its own; logs/ gets one log per job.  Rows depend on nothing but the
# seeds; `fps` is host dispatch under that sharing, not a speed.
set -eu
REPO=$(cd "$(dirname "$0")/.." && pwd)
OUT=$(mkdir -p "${1:-$REPO/accuracy_torch}" && cd "${1:-$REPO/accuracy_torch}" && pwd)
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
export SF_ADV_CACHE="${SF_ADV_CACHE:-/tmp/sf_adv_cache}"
export OMP_NUM_THREADS="${OMP_NUM_THREADS:-2}"
mkdir -p "$OUT/logs"
cd "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > logs/card.txt
stamp() { date -u +%FT%TZ; }

echo "render start $(stamp)"
python3 -m staticfusion_tpu_torch.apps.render_cache corridor_loop:1500:0 \
    > logs/render_corridor1500.log 2>&1 &
long=$!
pids=""
for spec in walk_xyz:100:0 walk_xyz:100:1 walk_xyz:100:2 \
            corridor_loop:300:0 corridor_loop:300:1 corridor_loop:300:2 \
            walk_xyz:100:0:1 walk_xyz:100:1:1 walk_xyz:100:2:1 \
            corridor_loop:200:0:1 walk_var:40:0 walk_var:40:1 walk_var:40:2; do
    python3 -m staticfusion_tpu_torch.apps.render_cache "$spec" \
        > "logs/render_$(echo "$spec" | tr : _).log" 2>&1 &
    pids="$pids $!"
done
for p in $pids; do wait "$p"; done
echo "render done (all but corridor1500) $(stamp)"

run() {   # run NAME COMMAND...: one job, its log and its exit code
    name=$1; shift
    { echo "start $(stamp)"; rc=0; "$@" || rc=$?; echo "end $(stamp) rc=$rc"; } \
        > "logs/$name.log" 2>&1
}
run headline sh -c 'for s in 0 1 2; do python3 -m staticfusion_tpu_torch.apps.accuracy_bench --profiles walk_xyz --factors 4 --frames 100 --seed $s --json ACC_r4_final_s$s.json || exit 1; done' &
jobs="$!"
for group in corridor corrlam vga walkvar; do
    run "$group" python3 -m staticfusion_tpu_torch.apps.r5_suite "$group" &
    jobs="$jobs $!"
done
for p in $jobs; do wait "$p"; done
wait "$long"
echo "runs done $(stamp)"
grep -h "rc=" logs/headline.log logs/corridor.log logs/corrlam.log \
    logs/vga.log logs/walkvar.log
python3 -m staticfusion_tpu_torch.apps.check_closures \
    ACC_r5_corridor_on_s0.json ACC_r5_corridor_on_s1.json \
    ACC_r5_corridor_on_s2.json ACC_r5_corridor1500_on_s0.json \
    > check_closures.txt
grep '^{' check_closures.txt
