"""tc2li_slam_tpu — tightly-coupled camera–LiDAR–inertial SLAM on an accelerator.

A from-scratch JAX/XLA re-design of the capabilities of TC2LI-SLAM
(ORB-SLAM3 stereo(-inertial) tracking + FAST-LIO2 iterated-ESEKF LiDAR-inertial
odometry + BALM2 plane eigen-factor LiDAR bundle adjustment), built as
fixed-shape device programs:

- map state lives in fixed-capacity device arrays (voxel hash instead of
  ikd-tree, padded pools instead of pointer graphs),
- all per-frame numerics are jitted batched programs,
- one Levenberg–Marquardt factor-graph core replaces g2o,
- multi-chip scaling via ``jax.sharding`` meshes + collectives, not threads.

Subpackages
-----------
geom         Lie groups (SO3/SE3/Sim3), camera models, triangulation.
ops          Batched vision + LiDAR kernels (ORB, matching, voxel map, plane fit).
estimation   IMU preintegration, iterated ESEKF, scan undistortion.
solver       LM/GN factor-graph core, reprojection/IMU/BALM factors, PnP, Sim3.
slam         Map pools, tracking state machine, local mapping, system facade.
parallel     Device-mesh sharding of the factor graph + distributed BA.
numerics     Float32 matmul precision policy of the solvers and filters.
io           KITTI-format dataset loading, synthetic world generation.
"""

__version__ = "0.1.0"


def _enable_compilation_cache():
    """Persistent XLA compilation cache (opt-out via TC2LI_NO_JIT_CACHE).

    The system compiles ~20 large programs (frame build, tracking, BA, LIO);
    caching them on disk lets every process after the first start quickly.
    ``JAX_COMPILATION_CACHE_DIR``, when set, is the only cache directory
    (JAX reads it itself); otherwise the cache lives at the fixed
    ``<repo>/.jax_cache/<machine tag>``.
    """
    import os

    if os.environ.get("TC2LI_NO_JIT_CACHE"):
        return

    def machine_tag():
        # XLA:CPU AOT artifacts bake in the compile machine's feature set;
        # loading them on a host without those features can SIGILL, so each
        # machine type (keyed by its CPU flags) gets its own directory.
        try:
            with open("/proc/cpuinfo") as fh:
                for line in fh:
                    if line.startswith("flags"):
                        import hashlib
                        return hashlib.md5(line.encode()).hexdigest()[:10]
        except OSError:
            pass
        import platform
        return platform.machine() or "generic"

    import jax

    try:
        if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            cache = os.path.join(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))), ".jax_cache", machine_tag())
            jax.config.update("jax_compilation_cache_dir", cache)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    except Exception as e:  # the cache only saves time; run without it
        import warnings
        warnings.warn(f"persistent compilation cache disabled: {e}")


_enable_compilation_cache()
