"""File readers — the reference's user workflow starts from force-field files.

atomsmm's own tests and docs build every System from AMBER ``.prmtop`` /
``.inpcrd`` pairs via ``openmm.app.AmberPrmtopFile`` (SURVEY.md §2a Tests row:
``tests/data/`` holds q-SPC/FW water, emim/BF4 and phenol+water AMBER files).
This package provides the equivalent: parse the files with numpy,
emit our ``System`` pytree directly.
"""
from .amber import AmberPrmtop, amber_system, read_inpcrd, read_prmtop
from .pdb import PDBFile, read_pdb, write_pdb

__all__ = [
    "AmberPrmtop",
    "PDBFile",
    "amber_system",
    "read_inpcrd",
    "read_pdb",
    "read_prmtop",
    "write_pdb",
]
