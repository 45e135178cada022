import os

# Tests run on the CPU backend, on a virtual 8-device mesh so the
# multi-device sharding logic is exercised without accelerator hardware
# (chip_smoke.py --multi runs the sharded path on real cards).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# Oracle tests compare against scipy/numpy references in double precision.
jax.config.update("jax_enable_x64", True)
