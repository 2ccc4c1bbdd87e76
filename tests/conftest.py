"""Test configuration: CPU backend with 8 virtual devices + float64.

This is our "Reference platform" (SURVEY.md §4): the reference's tests pin
OpenMM's deterministic f64 Reference platform; ours pin the CPU JAX backend
with x64 enabled, and an 8-device virtual mesh for sharding tests. Must run
before jax is imported anywhere.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# Persistent XLA compilation cache: the suite is compile-dominated
# (hundreds of small jitted step/energy functions), so warm reruns skip most
# of that. JAX_COMPILATION_CACHE_DIR wins where it is set; otherwise the
# cache sits at <checkout>/.jax_cache (gitignored — entries are
# platform/version-specific). Harmless when cold.
from atomsmm_tpu.utils import enable_compile_cache  # noqa: E402

enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
