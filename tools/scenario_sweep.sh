#!/bin/bash
# Sweep all reference scenarios closed-loop and record pass/fail +
# rule violations, like the reference's test harness runs scenarios to
# sim.finished (library/test/test_sim.py:134-145).  The acc_2024 trio
# additionally runs under the DP lat/lon planner (the reference's own
# scenario x planner matrix, test_sim.py:17-51).
#
# Classification per scenario:
#   PASS [FULL ...]    ran to its manager-set finish, zero violations
#   PASS [WINDOW ...]  zero violations for the whole observed window:
#                      either the manager never sets finished (endless
#                      demo loops, capped at --max-t 120) or the wall
#                      timeout hit first (sim time reached is recorded)
#   VIOL               rule violations occurred
#   FAIL               crashed
#
# Per-scenario results land in <out>.d/ so an interrupted sweep resumes
# (delete a result file to re-run that scenario); the final log is the
# concatenation in deterministic order plus a DONE marker.
#
# Usage: tools/scenario_sweep.sh [out.log] [wall_timeout_s] [jobs]
#   jobs > 1 runs scenarios in parallel: safe for pass/fail (the sim is
#   deterministic fixed-step), but planner_mean_ms values are then
#   recorded under load — informational only.
set -u
out=${1:-/tmp/scenario_sweep.log}
wall=${2:-1500}
jobs=${3:-1}
cd "$(dirname "$0")/.."
scen_root=${SCEN_ROOT:-${TPL_TPU_DATA:?set TPL_TPU_DATA (or SCEN_ROOT) to a tpl data root}/scenarios}
resdir="$out.d"
mkdir -p "$resdir"
cached=$(ls "$resdir" 2>/dev/null | wc -l)
if [ "$cached" -gt 0 ]; then
    echo "NOTE: resuming with $cached cached results from $resdir —" \
         "they reflect the code at the time they ran;" \
         "rm -r '$resdir' to sweep fresh" >&2
fi

run_one() {
    # $1 = scenario path; $2 = planner ("" = scenario default)
    local s=$1 planner=${2:-}
    local tag=${s//\//-}
    [ -n "$planner" ] && tag="$tag@$planner"
    local res_file="$resdir/$tag.res"
    [ -s "$res_file" ] && return 0

    local d="$scen_root/$s"
    local cap="" kind=FULL popt=() label=$s
    if ! grep -q "finished" "$d/manager.py" 2>/dev/null; then
        cap="--max-t 120"
        kind=WINDOW
    fi
    if [ -n "$planner" ]; then
        popt=(--planner "$planner")
        label="$s [$planner]"
    fi
    local res
    res=$(timeout "$wall" python3 -m tpl_tpu.simulation.tplsim run \
        --scenario "$s" --headless --cpu --no-reload --verbose $cap \
        "${popt[@]}" --app-id "sweep-$tag" 2>&1 | tail -25)
    local viol fin simt rt
    viol=$(echo "$res" | grep -oP 'rule violations: \K\d+' | tail -1)
    {
    if [ -n "$viol" ]; then
        # run completed (finished or max-t reached)
        fin=$(echo "$res" | grep -oP 'finished=\K\w+' | tail -1)
        simt=$(echo "$res" | grep -oP 'scenario .*: t=\K[0-9.]+' | tail -1)
        rt=$(echo "$res" | grep -oP 'mean=\K[0-9.]+' | tail -1)
        if [ "$viol" != "0" ]; then
            echo "VIOL  $label  violations=$viol  t=${simt}s finished=$fin"
            echo "$res" | grep SimRuleViolation | head -2 | sed 's/^/    /'
        else
            echo "PASS  $label  [$kind t=${simt}s finished=$fin] planner_mean_ms=$rt"
        fi
    else
        # wall timeout killed the run: classify from the last verbose line
        local lt lv
        lt=$(echo "$res" | grep -oP '^t=\s*\K[0-9.]+' | tail -1)
        lv=$(echo "$res" | grep -oP 'violations=\K\d+' | tail -1)
        if [ "$lv" = "0" ] && [ -n "$lt" ]; then
            echo "PASS  $label  [WINDOW t=${lt}s wall-timeout]"
        elif [ -n "$lv" ]; then
            echo "VIOL  $label  violations=$lv  t=${lt}s (wall-timeout)"
        else
            echo "FAIL  $label  (crash)"
            echo "$res" | sed 's/^/    /'
        fi
    fi
    } > "$res_file"
}
export -f run_one
export scen_root resdir wall

# deterministic work list: every scenario with its default planner,
# plus the acc_2024 trio under the DP grid planner
worklist=$(mktemp)
for d in "$scen_root"/*/ "$scen_root"/*/*/; do
    [ -f "$d/state.json" ] || continue
    s=${d#"$scen_root"/}; s=${s%/}
    echo "$s|" >> "$worklist"
done
for s in acc_2024/cv_3o acc_2024/ot_2o acc_2024/rb_3o; do
    echo "$s|dp_lat_lon_planner" >> "$worklist"
done
sort -u "$worklist" -o "$worklist"

if [ "$jobs" -gt 1 ]; then
    xargs -a "$worklist" -P "$jobs" -I{} bash -c \
        'IFS="|" read -r s p <<< "{}"; run_one "$s" "$p"'
else
    while IFS="|" read -r s p; do run_one "$s" "$p"; done < "$worklist"
fi

# assemble the final log in work-list order
: > "$out"
while IFS="|" read -r s p; do
    tag=${s//\//-}
    [ -n "$p" ] && tag="$tag@$p"
    cat "$resdir/$tag.res" >> "$out" 2>/dev/null \
        || echo "FAIL  $s ${p:+[$p]}  (no result recorded)" >> "$out"
done < "$worklist"
rm -f "$worklist"
echo "DONE" >> "$out"
