"""atomsmm_tpu — a JAX molecular dynamics engine with the capabilities
of atoms-ufrj/atomsmm (see SURVEY.md for the reference analysis and its
evidentiary status, BASELINE.md for targets).

Public facade mirroring atomsmm/__init__.py: forces, systems, integrators,
propagators, reporters, computers, utils are all re-exported here.
"""

__version__ = "0.1.0"

from . import units
from .context import Context, StateSnapshot
from .forces import (
    CMAPTorsionForce,
    CustomBondForce,
    MonteCarloBarostat,
    CustomNonbondedForce,
    DampedSmoothedForce,
    DrudeForce,
    FarNonbondedForce,
    HarmonicImproperForce,
    PMEReciprocalForce,
    HarmonicAngleForce,
    HarmonicBondForce,
    NearNonbondedForce,
    NonbondedExceptionsForce,
    NonbondedForce,
    PeriodicTorsionForce,
    SoftcoreLennardJonesForce,
    TemplateBondedForce,
)
from .integrate.integrators import (
    GlobalThermostatIntegrator,
    Integrator,
    LangevinMiddleIntegrator,
    MultipleTimeScaleIntegrator,
    PropagatorIntegrator,
    VelocityVerletIntegrator,
)
from .integrate.propagators import (
    BoostPropagator,
    ChainedPropagator,
    GenericBoostPropagator,
    GenericScalingPropagator,
    NoseHooverChainPropagator,
    OrnsteinUhlenbeckPropagator,
    Propagator,
    RespaPropagator,
    SplitPropagator,
    SuzukiYoshidaPropagator,
    TranslationPropagator,
    TrotterSuzukiPropagator,
    VelocityRescalingPropagator,
    VelocityVerletPropagator,
)
from .potential import (
    force_fn,
    group_energies,
    potential_energy,
    split_potential_energy,
)
from .state import (
    State,
    kinetic_energy,
    make_state,
    maxwell_boltzmann_velocities,
    remove_com_motion,
)
from .system import System, make_exclusions_array
from .systems import (
    AlchemicalRespaSystem,
    ComputingSystem,
    HydrogenMassRepartitionedSystem,
    RESPASystem,
    SolvationSystem,
)
from .utils import (
    InputError,
    count_degrees_of_freedom,
    find_nonbonded_force,
    hijack_force,
)
from .app import Simulation
from .alchemy import (
    mbar_free_energies,
    multistate_energies,
    reduced_energy_matrix,
    ti_gradient,
)
from .computers import PressureComputer
from .integrate.sinr import (
    IsokineticBoostPropagator,
    MassiveNoseHooverLangevinPropagator,
    MassiveNoseHooverPropagator,
    NHL_R_Integrator,
    SIN_R_Integrator,
    SINRThermostatPropagator,
)
from .integrate.drude import (
    DrudeLangevinIntegrator,
    DrudeOrnsteinUhlenbeckPropagator,
    DrudeSCFIntegrator,
)
from .minimize import fire_minimize, minimize_energy
from .reporters import (
    CenterOfMassReporter,
    CustomIntegratorReporter,
    ExtendedStateDataReporter,
    PDBReporter,
    StateDataReporter,
    XYZReporter,
)
from .checkpoint import load_checkpoint, save_checkpoint
from .io import (
    AmberPrmtop,
    PDBFile,
    amber_system,
    read_inpcrd,
    read_pdb,
    read_prmtop,
    write_pdb,
)
from .profiling import profile_forces, profile_step
