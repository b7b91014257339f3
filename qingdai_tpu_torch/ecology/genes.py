"""Gene definitions: host-side dataclass + packed device arrays.

The reference keeps a Python list of ``Genes`` objects with variable-length
peak lists (pygcm/ecology/genes.py:10-92). For the TPU the
genome is packed into fixed-shape arrays [S_slots, P_MAX, 3] with zero-height
padding, so mutation (adapter.py:471-515) can run inside the jitted daily step.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np

P_MAX = 4  # max Gaussian absorption peaks per genome (default genes use 2)


@dataclasses.dataclass
class Peak:
    center_nm: float
    width_nm: float
    height: float


@dataclasses.dataclass
class Genes:
    """Host-side genome (matches reference field set, genes.py:19-41)."""
    identity: str = "grass"
    alloc_root: float = 0.3
    alloc_stem: float = 0.2
    alloc_leaf: float = 0.5
    leaf_area_per_energy: float = 2.0e-3
    absorption_peaks: List[Peak] = dataclasses.field(default_factory=list)
    drought_tolerance: float = 0.3
    gdd_germinate: float = 80.0
    lifespan_days: int = 365
    provenance: Optional[str] = None

    def normalized(self) -> "Genes":
        s = self.alloc_root + self.alloc_stem + self.alloc_leaf
        if s <= 0:
            self.alloc_root, self.alloc_stem, self.alloc_leaf = 0.3, 0.2, 0.5
        else:
            self.alloc_root /= s
            self.alloc_stem /= s
            self.alloc_leaf /= s
        return self

    @staticmethod
    def from_env(prefix: str = "QD_ECO_GENE_") -> "Genes":
        """Parse QD_ECO_GENE_*/QD_ECO_SPECIES_{i}_* env genome (genes.py:43-92)."""
        def f(name, default):
            try:
                return float(os.getenv(prefix + name, str(default)))
            except (TypeError, ValueError):
                return default

        peaks_env = (os.getenv(prefix + "PEAKS", "") or "").strip()
        peaks: List[Peak] = []
        if peaks_env:
            for p in peaks_env.split(","):
                try:
                    c, w, h = p.strip().split(":")
                    peaks.append(Peak(float(c), float(w), float(h)))
                except ValueError:
                    continue
        if not peaks:
            peaks = [Peak(450.0, 40.0, 0.6), Peak(680.0, 30.0, 0.8)]

        g = Genes(
            identity=(os.getenv(prefix + "IDENTITY", "grass") or "grass").strip(),
            alloc_root=f("ALLOC_ROOT", 0.3),
            alloc_stem=f("ALLOC_STEM", 0.2),
            alloc_leaf=f("ALLOC_LEAF", 0.5),
            leaf_area_per_energy=f("LEAF_AREA_PER_EN", 2.0e-3),
            absorption_peaks=peaks,
            drought_tolerance=f("DROUGHT_TOL", 0.3),
            gdd_germinate=f("GDD_GERMINATE", 80.0),
            lifespan_days=int(f("LIFESPAN_DAYS", 365)),
            provenance=f"env:{prefix}",
        )
        return g.normalized()


def absorbance_from_genes(lambda_centers: np.ndarray, genes: Genes) -> np.ndarray:
    """Band absorbance A_b in [0,1] (genes.py:95-111), host-side."""
    lam = np.asarray(lambda_centers, float)
    A = np.zeros_like(lam)
    for pk in genes.absorption_peaks:
        if pk.width_nm <= 0 or pk.height <= 0:
            continue
        A += pk.height * np.exp(-((lam - pk.center_nm) ** 2) / (2 * pk.width_nm ** 2))
    return np.clip(A, 0.0, 1.0)


def reflectance_from_genes(lambda_centers: np.ndarray, genes: Genes) -> np.ndarray:
    return np.clip(1.0 - absorbance_from_genes(lambda_centers, genes), 0.0, 1.0)


def pack_genes(genes_list: List[Genes], s_slots: int) -> dict:
    """Pack a genome list into fixed-shape arrays (inactive slots zeroed)."""
    S = s_slots
    peaks = np.zeros((S, P_MAX, 3), np.float32)
    alloc = np.zeros((S, 3), np.float32)
    lape = np.zeros((S,), np.float32)
    tol = np.full((S,), 0.5, np.float32)
    gdd = np.zeros((S,), np.float32)
    lifespan = np.zeros((S,), np.float32)
    for i, g in enumerate(genes_list[:S]):
        for p, pk in enumerate(g.absorption_peaks[:P_MAX]):
            peaks[i, p] = (pk.center_nm, pk.width_nm, pk.height)
        alloc[i] = (g.alloc_root, g.alloc_stem, g.alloc_leaf)
        lape[i] = g.leaf_area_per_energy
        tol[i] = g.drought_tolerance
        gdd[i] = g.gdd_germinate
        lifespan[i] = g.lifespan_days
    return {"peaks": peaks, "alloc": alloc, "leaf_area_per_energy": lape,
            "drought_tolerance": tol, "gdd_germinate": gdd, "lifespan_days": lifespan}


def unpack_genes(packed: dict, n_active: int, identities: Optional[List[str]] = None
                 ) -> List[Genes]:
    """Device arrays → host Genes list (for genes.json export)."""
    out: List[Genes] = []
    peaks = np.asarray(packed["peaks"])
    alloc = np.asarray(packed["alloc"])
    for i in range(int(n_active)):
        pk_list = [Peak(float(c), float(w), float(h))
                   for c, w, h in peaks[i] if h > 0]
        g = Genes(
            identity=(identities[i] if identities and i < len(identities) else f"sp{i}"),
            alloc_root=float(alloc[i, 0]), alloc_stem=float(alloc[i, 1]),
            alloc_leaf=float(alloc[i, 2]),
            leaf_area_per_energy=float(np.asarray(packed["leaf_area_per_energy"])[i]),
            absorption_peaks=pk_list,
            drought_tolerance=float(np.asarray(packed["drought_tolerance"])[i]),
            gdd_germinate=float(np.asarray(packed["gdd_germinate"])[i]),
            lifespan_days=int(np.asarray(packed["lifespan_days"])[i]),
        )
        out.append(g)
    return out
