"""Library-surface verification on the default (GPU) backend — see
.claude/skills/verify."""
import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import atomsmm_tpu as amm
from atomsmm_tpu.models import argon_system, water_system
system, x, box = argon_system(n=500, jitter=0.05, seed=1)
ctx = amm.Context(system, amm.VelocityVerletIntegrator(dt=0.002), amm.make_state(x, box=box))
ctx.set_velocities_to_temperature(120.0, seed=3)
e0 = float(ctx.conserved_energy()); ctx.step(500); e1 = float(ctx.conserved_energy())
drift = abs(e1 - e0) / 500
print(f"NVE drift/atom over 500 steps: {drift:.2e} kJ/mol (bar 1e-4)")
assert drift < 1e-4

# RESPA water on the GPU: NVT temperature + split consistency
system, x, box = water_system(n_molecules=256, method="cutoff", neighbors=True)
respa = amm.RESPASystem(system, rcut_in=0.5, rswitch_in=0.4)
integ = amm.MultipleTimeScaleIntegrator(0.004, [4, 2, 1], temperature=300.0,
                                        time_scale=0.1,
                                        degrees_of_freedom=3*system.num_particles-3)
print(integ.describe()[:200])
ctx = amm.Context(respa, integ, amm.make_state(x, box=box))
ctx.set_velocities_to_temperature(300.0, seed=7)
# lattice melt releases PE faster than the tau=0.1 ps NHC removes it:
# chunked velocity rescales first (the bench's _melt_equilibrate pattern)
for _ in range(6):
    ctx.step(50)
    t_now = float(ctx.temperature())
    ctx.set_velocities((300.0 / t_now) ** 0.5 * ctx.state.v)
ctx.step(300)
T = float(ctx.temperature())
print(f"NVT T after melt equilibration + 300 steps: {T:.1f} K")
assert 250 < T < 350
snap = ctx.get_state()
tot = float(snap.energy_split["Total"])
parts = sum(float(v) for k, v in snap.energy_split.items() if k != "Total")
print(f"split sum {parts:.3f} vs Total {tot:.3f}")
assert abs(parts - tot) < 1e-2 * max(1.0, abs(tot))
print("verify surface OK")
