"""LSMS physics utilities: total energy -> formation enthalpy / Gibbs free
energy, and the compositional histogram cutoff.

Counterpart of ``hydragnn_tpu/data/lsms.py``: host-side steps that rewrite
or downselect raw LSMS text files before graphs are built (numpy only; the
plots import matplotlib when asked for). LSMS raw file layout (one
configuration per file): a header line whose first token is the total
energy (Rydberg), then one line per atom whose first column is the atomic
number. Both utilities take binary alloys only.
"""

from __future__ import annotations

import dataclasses
import math
import os
import shutil
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# LSMS energies are in Rydberg (reference:
# convert_total_energy_to_formation_gibbs.py:176-179)
_KB_JOULE_PER_KELVIN = 1.380649e-23
_JOULE_TO_RYDBERG = 4.5874208973812e17
KB_RYDBERG_PER_KELVIN = _KB_JOULE_PER_KELVIN * _JOULE_TO_RYDBERG


def read_lsms_file(path: str) -> Tuple[float, np.ndarray, List[str]]:
    """(total_energy, atom_table, raw_lines) of one LSMS configuration
    (reference: read_file, convert_total_energy_to_formation_gibbs.py:22-27)."""
    with open(path, encoding="utf-8") as f:
        lines = f.readlines()
    total_energy = float(lines[0].split()[0])
    atoms = np.loadtxt(lines[1:], ndmin=2)
    return total_energy, atoms, lines


def _lsms_files(dir: str) -> List[str]:
    """Sorted LSMS sample filenames — one filtering rule shared with the
    raw loaders (data/raw.py: raw_sample_files)."""
    from .raw import raw_sample_files

    return raw_sample_files(dir)


def _read_energy_and_z(path: str) -> Tuple[float, np.ndarray]:
    """Header energy + Z column only — cheap first-pass parse."""
    with open(path, encoding="utf-8") as f:
        lines = f.readlines()
    total_energy = float(lines[0].split()[0])
    zs = np.array(
        [float(l.split()[0]) for l in lines[1:] if l.strip()], np.float64
    )
    return total_energy, zs


def _binary_composition(
    z: np.ndarray, elements_list: Sequence[float]
) -> Tuple[float, int, int]:
    """(fraction of the first element, count of first element, num atoms)
    with the reference's pure-component fixup
    (convert_total_energy_to_formation_gibbs.py:151-162)."""
    elements_list = sorted(elements_list)
    elements, counts = np.unique(z, return_counts=True)
    for e in elements:
        if e not in elements_list:
            raise ValueError(
                f"sample contains element {e} not in the binary {elements_list}"
            )
    count_map = dict(zip(elements.tolist(), counts.tolist()))
    n0 = int(count_map.get(elements_list[0], 0))
    num_atoms = int(z.shape[0])
    return n0 / num_atoms, n0, num_atoms


def mixing_entropy(num_atoms: int, count_first: int) -> float:
    """Ideal-mixing (thermodynamic) entropy Kb * ln C(n, k) in Rydberg/K.

    Same quantity as the reference (:180-183), computed with ``lgamma`` so
    it stays finite for configurations large enough to overflow a direct
    binomial coefficient.
    """
    log_comb = (
        math.lgamma(num_atoms + 1)
        - math.lgamma(count_first + 1)
        - math.lgamma(num_atoms - count_first + 1)
    )
    return KB_RYDBERG_PER_KELVIN * log_comb


def compute_formation_enthalpy(
    z: np.ndarray,
    total_energy: float,
    elements_list: Sequence[float],
    pure_elements_energy: Dict[float, float],
) -> Tuple[float, float, float, float]:
    """(composition, linear_mixing_energy, formation_enthalpy, entropy) for a
    binary-alloy configuration (reference: compute_formation_enthalpy,
    convert_total_energy_to_formation_gibbs.py:141-185).

    ``pure_elements_energy`` maps element -> per-atom energy of the pure
    phase; the formation enthalpy is the total energy minus the linear
    mixing of the pure-phase energies at this composition.
    """
    elements_list = sorted(elements_list)
    composition, n0, num_atoms = _binary_composition(z, elements_list)
    linear_mixing_energy = (
        pure_elements_energy[elements_list[0]] * composition
        + pure_elements_energy[elements_list[1]] * (1.0 - composition)
    ) * num_atoms
    formation_enthalpy = total_energy - linear_mixing_energy
    entropy = mixing_entropy(num_atoms, n0)
    return composition, linear_mixing_energy, formation_enthalpy, entropy


@dataclasses.dataclass
class GibbsConversionResult:
    """Per-file statistics of a conversion run, for inspection/plots."""

    files: List[str]
    compositions: np.ndarray
    total_energies: np.ndarray
    linear_mixing_energies: np.ndarray
    formation_enthalpies: np.ndarray
    formation_gibbs_energies: np.ndarray
    output_dir: str


def convert_total_energy_to_formation_gibbs(
    dir: str,
    elements_list: Sequence[float],
    temperature_kelvin: float = 0.0,
    overwrite_data: bool = False,
    create_plots: bool = False,
) -> GibbsConversionResult:
    """Rewrite every LSMS file in ``dir`` with the total energy replaced by
    the formation Gibbs energy ``dH - T*S`` into ``<dir>_gibbs_energy/``
    (reference: convert_raw_data_energy_to_gibbs,
    convert_total_energy_to_formation_gibbs.py:30-139).

    Pure-element reference energies are discovered from the single-element
    configurations in the directory (two are required, binary alloys only).
    """
    dir = dir.rstrip("/")
    new_dir = dir + "_gibbs_energy"
    if os.path.exists(new_dir):
        if overwrite_data:
            shutil.rmtree(new_dir)
        else:
            # refusing beats silently mixing stale conversions (possibly
            # anchored on different pure-phase energies) into the output
            raise FileExistsError(new_dir)
    os.makedirs(new_dir)

    elements_list = sorted(elements_list)
    all_files = _lsms_files(dir)

    # pass 1: per-atom energies of the pure-element configurations (:52-63).
    # Light parse (header + Z column only) — the full atom table is only
    # needed by pass 2, so large directories are not loadtxt'd twice.
    pure_elements_energy: Dict[float, float] = {}
    for filename in all_files:
        total_energy, zs = _read_energy_and_z(os.path.join(dir, filename))
        pure = np.unique(zs)
        if len(pure) == 1:
            pure_elements_energy[float(pure[0])] = total_energy / zs.shape[0]
    if len(pure_elements_energy) != 2:
        raise ValueError(
            f"need exactly two single-element files to anchor the binary; "
            f"found pure phases for {sorted(pure_elements_energy)}"
        )

    # pass 2: formation enthalpy -> Gibbs, rewrite header (:75-107)
    n = len(all_files)
    comps = np.zeros(n)
    totals = np.zeros(n)
    linmix = np.zeros(n)
    enthalpy = np.zeros(n)
    gibbs = np.zeros(n)
    for i, filename in enumerate(all_files):
        path = os.path.join(dir, filename)
        total_energy, atoms, lines = read_lsms_file(path)
        comp, lm, dh, entropy = compute_formation_enthalpy(
            atoms[:, 0], total_energy, elements_list, pure_elements_energy
        )
        g = dh - temperature_kelvin * entropy
        comps[i], totals[i], linmix[i], enthalpy[i], gibbs[i] = (
            comp, total_energy, lm, dh, g,
        )
        header_tok = lines[0].split()[0]
        lines[0] = lines[0].replace(header_tok, repr(g), 1)
        with open(os.path.join(new_dir, filename), "w", encoding="utf-8") as f:
            f.write("".join(lines))

    result = GibbsConversionResult(
        files=all_files,
        compositions=comps,
        total_energies=totals,
        linear_mixing_energies=linmix,
        formation_enthalpies=enthalpy,
        formation_gibbs_energies=gibbs,
        output_dir=new_dir,
    )
    if create_plots:
        _plot_conversion(result)
    return result


def _plot_conversion(result: GibbsConversionResult) -> None:
    """Scatter plots of the conversion (reference: :111-139)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    # plots live next to the converted data, so runs on different datasets
    # from one cwd don't overwrite each other
    for fname, xs, ys, xl, yl in (
        ("linear_mixing_energy.png", result.total_energies,
         result.linear_mixing_energies, "Total energy (Rydberg)",
         "Linear mixing energy (Rydberg)"),
        ("formation_enthalpy.png", result.compositions,
         result.formation_enthalpies, "Concentration",
         "Formation enthalpy (Rydberg)"),
        ("formation_gibbs_energy.png", result.compositions,
         result.formation_gibbs_energies, "Concentration",
         "Formation Gibbs energy (Rydberg)"),
    ):
        plt.figure()
        plt.scatter(xs, ys, edgecolor="b", facecolor="none")
        plt.xlabel(xl)
        plt.ylabel(yl)
        plt.savefig(os.path.join(result.output_dir, fname))
        plt.close()


def find_bin(comp: float, nbins: int) -> int:
    """Composition -> histogram bin: ``nbins`` equal half-open bins over
    [0, 1], with comp == 1.0 in the last bin.

    Deviates deliberately from the reference (compositional_histogram_cutoff
    .py:8-13), whose strict-inequality scan drops every on-edge composition —
    including both pure endpoints 0.0 and 1.0 — into the last bin, making
    the endmembers share one bin budget.
    """
    return min(int(np.floor(comp * nbins)), nbins - 1)


def compositional_histogram_cutoff(
    dir: str,
    elements_list: Sequence[float],
    histogram_cutoff: int,
    num_bins: int,
    overwrite_data: bool = False,
    link: bool = True,
) -> List[str]:
    """Downselect LSMS files to at most ``histogram_cutoff - 1`` samples per
    composition bin, linking the keepers into ``<dir>_histogram_cutoff/``
    (reference: compositional_histogram_cutoff.py:16-75, which keeps a
    sample while its bin count is strictly below the cutoff *after*
    increment). ``link=False`` copies instead of symlinking (for
    filesystems without symlink support). Returns the kept filenames.
    """
    dir = dir.rstrip("/")
    new_dir = dir + "_histogram_cutoff"
    if os.path.exists(new_dir):
        if overwrite_data:
            shutil.rmtree(new_dir)
        else:
            raise FileExistsError(new_dir)
    os.makedirs(new_dir)

    kept: List[str] = []
    bin_counts = np.zeros(num_bins, np.int64)
    for filename in _lsms_files(dir):
        path = os.path.join(dir, filename)
        _, zs = _read_energy_and_z(path)
        comp, _, _ = _binary_composition(zs, elements_list)
        b = find_bin(comp, num_bins)
        bin_counts[b] += 1
        if bin_counts[b] < histogram_cutoff:
            kept.append(filename)
            new_path = os.path.join(new_dir, filename)
            if link:
                os.symlink(os.path.abspath(path), new_path)
            else:
                shutil.copyfile(path, new_path)
    return kept
