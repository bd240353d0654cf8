"""Battery-simulator parameter exporters (the port's own copy of
``openimpala_tpu/io/cathode.py``).

Re-design of ``OpenImpala::CathodeWrite`` (``src/io/CathodeWrite.{H,cpp}``):
bridge measured microstructure metrics to DandeLiion text and PyBamm CSV
parameter files.  Derived quantities (``CathodeWrite.cpp:48-62,118-125``):

    porosity            = 1 - vf_solid
    BET / surface area  = 3 * vf_solid / R
    permeability B      = porosity / 1.94
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class CathodeParams:
    """Mirrors the reference ``CathodeParams`` struct (``CathodeWrite.H:20-33``)."""

    volume_fraction_solid: float = 0.5  # [-] active material fraction
    particle_radius: float = 5e-6  # [m]
    active_material_conductivity: float = 100.0  # [S/m]
    max_concentration: float = 51000.0  # [mol/m^3]


def _derived(p: CathodeParams):
    porosity = 1.0 - p.volume_fraction_solid
    eps = 2.220446049250313e-16
    bet = (3.0 * p.volume_fraction_solid / p.particle_radius
           if p.particle_radius > eps else 0.0)
    perm_b = porosity / 1.94
    return porosity, bet, perm_b


def write_dandeliion_parameters(params: CathodeParams, filename: str) -> bool:
    """DandeLiion text format (``CathodeWrite.cpp:35-100``)."""
    porosity, bet, perm_b = _derived(params)
    lines = [
        "###########################################################",
        "# Cathode parameter container (Generated by CathodeWrite) #",
        "# Units should correspond to DandeLiion expectations.     #",
        "###########################################################",
        "",
        "N = 55                # Number of mesh nodes in liquid (Example value)",
        "M = 50                # Number of mesh nodes in solid (Example value)",
        "",
        f"R = {params.particle_radius:.8e}          # Particle radius, m",
        "",
        f"el      = {porosity:.8e}        # Volume fraction of electrolyte, Calculated (1 - vf_solid)",
        f"bet     = {bet:.8e}  # BET surface area, m^-1",
        f"B       = {perm_b:.8e}   # Permeability factor of electrolyte",
        f"cmax    = {params.max_concentration:.8e}   # Maximum concentration of Li ions in solid, mol m^-3",
        f"sigma_s = {params.active_material_conductivity:.8e}    # Solid conductivity, S m^-1",
        "###########################################################",
    ]
    with open(filename, "w") as f:
        f.write("\n".join(lines) + "\n")
    return True


def write_pybamm_parameters(params: CathodeParams, filename: str) -> bool:
    """PyBamm ``Name [units],Value,Reference,Notes`` CSV
    (``CathodeWrite.cpp:103-175``)."""
    porosity, surface_area, _ = _derived(params)
    rows = [
        "Name [units],Value,Reference,Notes",
        "# Parameter file generated by CathodeWrite,,,",
        "# Units should correspond to PyBamm expectations,,,",
        ",,,",
        "# Electrode properties,,,",
        f"Positive electrode conductivity [S.m-1],{params.active_material_conductivity:.8f},OpenImpala Calculated Parameter,",
        f"Maximum concentration in positive electrode [mol.m-3],{params.max_concentration:.8f},OpenImpala Calculated Parameter,",
        "Positive electrode diffusivity [m2.s-1],[function]lico2_diffusivity_Dualfoil1998,,Requires Function Definition in PyBamm",
        "Positive electrode OCP [V],[function]lico2_ocp_Dualfoil1998,,",
        ",,,",
        "# Microstructure,,,",
        f"Positive electrode porosity,{porosity:.8f},OpenImpala Calculated Parameter,electrolyte volume fraction (1 - vf_solid)",
        f"Positive electrode active material volume fraction,{params.volume_fraction_solid:.8f},OpenImpala Calculated Parameter,",
        f"Positive particle radius [m],{params.particle_radius:.8f},OpenImpala Calculated Parameter,",
        f"Positive electrode surface area density [m-1],{surface_area:.8f},OpenImpala Calculated Parameter,Calculated as 3*vf_solid/R",
        ",,,",
        "# Interfacial reactions,,,",
        "Positive electrode cation signed stoichiometry,-1,,",
        "Positive electrode electrons in reaction,1,,",
        ",,,",
        ",,,",
    ]
    with open(filename, "w") as f:
        f.write("\n".join(rows) + "\n")
    return True
