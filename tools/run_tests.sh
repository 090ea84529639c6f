#!/usr/bin/env bash
# One-command green test run for memory-constrained hosts.
#
# A single-process `pytest -m "not slow"` run accumulates XLA:CPU executables
# and fixture arrays past what a 2-CPU / small-RAM host can hold and dies
# with a fatal Python abort mid-suite. This runner
# keeps the suite green and verifiable by running it in a few fresh
# processes, grouped so each chunk stays well under the memory ceiling.
#
# Usage:
#   tools/run_tests.sh            # not-slow suite, chunked (CI default)
#   tools/run_tests.sh --slow     # additionally run the slow e2e chunk
#   EXTRA_ARGS="-q" tools/run_tests.sh
#
# Exit code: 0 iff every chunk passed.

set -u
cd "$(dirname "$0")/.."

PYTEST="${PYTEST:-python -m pytest}"
EXTRA_ARGS="${EXTRA_ARGS:--q}"
RUN_SLOW=0
[ "${1:-}" = "--slow" ] && RUN_SLOW=1

# Chunks sized by measured runtime/memory (solver/e2e files are the heavy
# ones): each runs in a fresh interpreter, so executables + fixtures are
# released between chunks.
CHUNKS=(
  "tests/test_lie.py tests/test_camera.py tests/test_orb.py tests/test_matching.py tests/test_triangulation.py tests/test_rectify.py tests/test_gpu.py tests/test_bench.py tests/test_cache_dir.py"
  "tests/test_voxel_map.py tests/test_imu.py tests/test_esekf.py tests/test_undistort.py tests/test_native.py tests/test_settings_eval.py tests/test_scan_features.py"
  "tests/test_solver.py tests/test_inertial_ba.py tests/test_inertial_init.py tests/test_pose_inertial.py tests/test_sim3_loop.py tests/test_precision.py"
  "tests/test_mapstate.py tests/test_culling.py tests/test_bow_reloc.py tests/test_loop_closing.py tests/test_viewer_profiling.py tests/test_atlas_checkpoint.py"
  "tests/test_e2e.py tests/test_reloc_system.py tests/test_robustness.py tests/test_imu_mode.py tests/test_loop_e2e.py"
  "tests/test_kitti_app.py tests/test_dist_ba.py tests/test_multihost.py"
  "tests/test_chip_smoke.py"
)

fail=0
i=0
t_all0=$(date +%s)
for chunk in "${CHUNKS[@]}"; do
  i=$((i + 1))
  t0=$(date +%s)
  echo "== chunk $i/${#CHUNKS[@]}: $chunk"
  # shellcheck disable=SC2086
  $PYTEST $EXTRA_ARGS -m "not slow" -p no:cacheprovider $chunk
  rc=$?
  # pytest rc 5 = no tests collected in this chunk (fine when filtered)
  if [ $rc -ne 0 ] && [ $rc -ne 5 ]; then
    echo "== chunk $i FAILED (rc=$rc)"
    fail=1
  fi
  echo "== chunk $i done in $(($(date +%s) - t0))s"
done

if [ $RUN_SLOW -eq 1 ]; then
  echo "== slow chunk"
  # shellcheck disable=SC2086
  $PYTEST $EXTRA_ARGS -m slow -p no:cacheprovider tests/
  rc=$?
  [ $rc -ne 0 ] && [ $rc -ne 5 ] && fail=1
fi

echo "== total $(($(date +%s) - t_all0))s, exit $fail"
exit $fail
