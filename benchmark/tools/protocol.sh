#!/bin/bash
# The measurement protocol of one cell: two sets of six runs on the same
# seeds, three traced runs and three more on new seeds (a dozen seeds in
# all), three runs of the lower-precision control and one run of each
# planted fault.
# usage: protocol.sh CELL SECONDS BASESEED [phases...]
#   phases: sets traced extra control faults probe (default: all but probe)
# Run from the checkout on a machine with the card the cell needs, e.g.
#   bash benchmark/tools/protocol.sh diff-t10.fleet 51 2147500013
# Each run's output goes to $PROTOCOL_OUT/CELL/<tag>.out and .err (default
# build/protocol); a summary goes to standard output. SHORT (default 20) is
# the window of the faults' and the probe's runs.
cd "$(dirname "$0")/../.."
CELL=$1; SECS=$2; BASE=$3; shift 3
PHASES=${@:-sets traced extra control faults}
SHORT=${SHORT:-20}
O=${PROTOCOL_OUT:-build/protocol}/$CELL; mkdir -p $O
nvidia-smi --query-gpu=name,power.limit,clocks.max.sm --format=csv,noheader
run() { # tag seed trace seconds extra...
  local tag=$1 seed=$2 tr=$3 secs=$4; shift 4
  local t0=$(date +%s%N)
  python3 benchmark/run.py --workload $CELL --seed $seed --seconds $secs --trace $tr "$@" > $O/$tag.out 2> $O/$tag.err
  local rc=$?
  local t1=$(date +%s%N)
  echo "== $tag seed=$seed rc=$rc wall_s=$(( (t1 - t0) / 1000000000 )) $*"
  [ $rc -ne 0 ] && { tail -c 3000 $O/$tag.err; return 1; }
  grep -E "^(window|setup phases)" $O/$tag.err | cut -c1-300
  python3 - "$O/$tag.out" "$O/$tag.err" <<'PY'
import json, sys
out = open(sys.argv[1]).read().strip().splitlines()
err = open(sys.argv[2]).read().splitlines()
seen = [l for l in err if l.startswith("seen: ")]
s = json.loads(seen[-1][6:]) if seen else {}
r = json.loads(out[-1])
m = {k: float("%.6g" % v["value"]) for k, v in r["metrics"].items()}
print("result", r["correct"], r["attempted"], r["failed"], m, r["device"].get("memory_peak_bytes"),
      {k: r["device"][k] for k in ("busy_s", "window_s") if k in r["device"]})
print("compared", {k: float("%.3g" % v["value"]) for k, v in r["checks"].items()})
print("more", {k: float("%.3g" % s[k]) for k in ("u_max", "chain_u_p90", "chain_u_max", "chain_s_p50",
                                                 "chain_yw_p50", "chain_u_share", "chain_n", "n") if k in s})
if "breakdown" in r:
    print("ops", [[n[:60], round(t, 5)] for n, t in r["breakdown"]["device_ops"][:6]])
    print("gaps", r["breakdown"]["idle_gaps"])
bad = {k: v for k, v in r["checks"].items() if not v["value"] <= v["limit"]}
if bad:
    print("FAILED", bad)
n = sum(l.startswith("past u_flip") for l in err)
if n:
    print("past_u_flip lines", n)
for l in err:
    if l.startswith("verdict"):
        print(l[:700])
PY
}
S=(); for i in $(seq 0 18); do S+=($((BASE + 7919 * i))); done
for ph in $PHASES; do
  case $ph in
    sets) for set in A B; do for i in 0 1 2 3 4 5; do run set$set$i ${S[$i]} 0 $SECS; done; done ;;
    traced) for i in 6 7 8; do run tr$i ${S[$i]} 1 $SECS; done ;;
    extra) for i in 9 10 11; do run x$i ${S[$i]} 0 $SECS --verdicts 6; done ;;
    control) for i in 12 13 14; do run ctl$i ${S[$i]} 0 $SECS --control tf32; done ;;
    faults) i=15; for f in state half answer; do run fault_$f ${S[$i]} 0 $SHORT --fault $f; i=$((i + 1)); done ;;
    probe) run probe ${S[18]} 0 $SHORT ;;
  esac
done
