#!/bin/bash
# Time an older checkout of the port against this one on the card, in turns
# (older, this, this, older): profile_port.py --hot (lm_ndt, K6 / K6b, K5,
# K6g, K7a and the rest at the main path's shapes, bench.py's headline
# shape and config 4's 10k graph, K9a's and K9c's library calls beside
# them, with output hashes, configs 1-3's box-world
# trajectories and bench.py §5's smoother cells); then, unless WHAT is "hot",
# profile_port.py on configs 3 and 2 (the box-world scenario, two
# kernel-route runs each after two warm-ups), and the CLI main path
# (ndtpu_torch.run's main on each config's own scene, config 3 at 600 scans
# and config 2 at 300: one warm-up run and two timed runs in one process).
# Last, one line per hot key: each run's event and card ms, and whether the
# outputs' hashes agree across runs. WHAT "window" runs only the window
# profiles: profile_port.py on configs 3 and 2 and with --serving (stacked
# serving, 8 x 300), two runs each, and --takes (configs 2 and 3, box-world
# draws 0-2), in the same turns; last, one line per run: serving's
# aggregate scans/s, its stages' shares of a window, device events and
# host syncs a window, and the hashes of its trajectories and final state
# and of each draw's.
#
#   bash compare_port.sh OLDER_CHECKOUT OUT_DIR [all|hot|window]
#
# OLDER_CHECKOUT holds `git archive` of the older commit; this checkout's
# profile_port.py and chip_smoke.py are copied into it first (they use only
# entry points that older ports have). Run from the root of this checkout;
# each result goes to OUT_DIR (profile JSON and logs, one line "CLI
# [scans/s] [ATE] [loops]" per CLI run).
set -u
older=$(cd "$1" && pwd)
out=$(mkdir -p "$2" && cd "$2" && pwd)
what=${3:-all}
here=$(pwd)
cp profile_port.py chip_smoke.py "$older/"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader \
  | tee "$out/card.txt"
i=0
for who in p c c p; do
  i=$((i + 1))
  if [ "$who" = p ]; then dir=$older; else dir=$here; fi
  if [ "$what" != window ]; then
    (cd "$dir" && timeout 600 python3 profile_port.py --hot \
      --out "$out/hot_${i}_${who}.json" > "$out/hot_${i}_${who}.log" 2>&1)
    echo "hot $i $who rc=$?"
  fi
  [ "$what" = hot ] && continue
  for cfg in config3_loop_closure config2_full_sequence; do
    (cd "$dir" && timeout 240 python3 profile_port.py \
      --config "configs/$cfg.json" --runs 2 \
      --out "$out/prof_${i}_${who}_${cfg}.json" \
      > "$out/prof_${i}_${who}_${cfg}.log" 2>&1)
    echo "profile $i $who $cfg rc=$?"
  done
  if [ "$what" = window ]; then
    (cd "$dir" && timeout 300 python3 profile_port.py --serving --runs 2 \
      --out "$out/prof_${i}_${who}_serving.json" \
      > "$out/prof_${i}_${who}_serving.log" 2>&1)
    echo "profile $i $who serving rc=$?"
    (cd "$dir" && timeout 300 python3 profile_port.py --takes \
      --out "$out/takes_${i}_${who}.json" > "$out/takes_${i}_${who}.log" 2>&1)
    echo "takes $i $who rc=$?"
    continue
  fi
  for spec in "config3_loop_closure 600" "config2_full_sequence 300"; do
    set -- $spec
    (cd "$dir" && timeout 150 python3 -c "
import sys
sys.path.insert(0, '.')
from ndtpu_torch import run
a = ['--config', 'configs/$1.json', '--max-scans', '$2', '--device', 'cuda']
run.main(a)
r = [run.main(a) for _ in range(2)]
print('CLI', [x['scans_per_s'] for x in r], [x['ate'] for x in r],
      [x['n_loops'] for x in r])
" > "$out/cli_${i}_${who}_$1.log" 2>&1)
    echo "cli $i $who $1 rc=$?"
    grep CLI "$out/cli_${i}_${who}_$1.log"
  done
done
if [ "$what" = window ]; then
  python3 - "$out" <<'PY'
import glob, json, sys
for f in sorted(glob.glob(sys.argv[1] + "/prof_*_serving.json")):
    r = json.load(open(f))["serving"]
    wall = r["stage_wall_s"]
    share = {k: round(100 * v / wall, 1) for k, v in r["stage_s"].items()}
    print(f.split("/")[-1], "scans/s", [round(x, 1) for x in
                                        r["aggregate_scans_per_s"]],
          "stage %", share, "events/window",
          round(r["device_events_per_window"], 1), "syncs/window",
          round(r["host_syncs"]["per_window"], 2), "sha", r.get("sha256"))
for f in sorted(glob.glob(sys.argv[1] + "/takes_*.json")):
    t = json.load(open(f))["takes"]
    print(f.split("/")[-1], {k: (v["loops"], v["ate_m"], v.get("traj_sha"),
                                 v.get("state_sha")) for k, v in t.items()})
PY
fi
# Hot's keys side by side: each run's event ms and card ms, and whether
# every run's outputs hash alike (SAME) or not (DIFF); a library call's
# outputs (float atomics) are not hashed ("library").
python3 - "$out" <<'PY'
import glob, json, sys
runs = [(f.split("_")[-1][0], json.load(open(f))["hot"])
        for f in sorted(glob.glob(sys.argv[1] + "/hot_*.json"))]
keys = {}
for _, r in runs:
    keys.update({k: v for k, v in r.items()
                 if isinstance(v, dict) and ("sha256" in v or "card_ms" in v)})
for key, row in keys.items():
    shas = {r.get(key, {}).get("sha256") for _, r in runs}
    cells = [f"{who} {r.get(key, {}).get('ms')} {r.get(key, {}).get('card_ms')}"
             for who, r in runs]
    same = ("library" if "sha256" not in row
            else "SAME" if len(shas) == 1 else "DIFF")
    print(f"{key}: {same} " + " | ".join(cells))
PY
