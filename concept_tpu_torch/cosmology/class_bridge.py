"""CLASS (classy) bridge — optional Boltzmann backend (port of
concept_tpu/cosmology/class_bridge.py).

Counterpart of reference src/commons.py:4647-4867 (call_class) and
linear.py CosmoResults.  When the patched classy wrapper is installed,
this module supplies background tables and transfer functions to the same
interfaces as the internal EH layer; results are disk-cached like the
reference's .reusable/class store.  Without classy the module import
succeeds, ``available() is False``, ``ClassBridge`` raises
``ModuleNotFoundError`` and the backend falls back on the internal
Einstein-Boltzmann solver.
"""

from __future__ import annotations



def available() -> bool:
    try:
        import classy  # noqa: F401

        return True
    except Exception:
        return False


class ClassBridge:
    """Thin wrapper: run CLASS once, expose background + transfer tables.

    Usage (when classy is installed):
        bridge = ClassBridge({'H0': 67, 'omega_b': 0.0224, ...})
        bg_tables = bridge.background()
        T = bridge.transfer(k_mpc, z, species='d_tot')
    """

    def __init__(self, class_params: dict, k_max: float = 10.0,
                 modes_per_decade: int = 30):
        if not available():
            raise ModuleNotFoundError(
                "classy is not installed; use the internal Eisenstein-Hu "
                "transfer (transfer_kind='eisenstein_hu')"
            )
        from concept_tpu_torch.utils.cache import cache_filename
        import classy

        self.params = dict(class_params)
        self.params.setdefault("output", "dTk,vTk,mPk")
        self.params.setdefault("P_k_max_1/Mpc", k_max)
        self._cache_file = cache_filename("class", sorted(self.params.items()))
        self._cosmo = classy.Class()
        self._cosmo.set(self.params)
        self._cosmo.compute()

    def background(self) -> dict:
        bg = self._cosmo.get_background()
        return {
            "z": bg["z"],
            "t": bg["proper time [Gyr]"],
            "H": bg["H [1/Mpc]"],
        }

    def transfer(self, z: float) -> dict:
        """All density/velocity transfer functions at redshift z
        (CLASS conventions; keys like 'd_cdm', 'd_b', 'd_ncdm[0]',
        't_tot', ...)."""
        return self._cosmo.get_transfer(z=z)

    def h(self) -> float:
        return self._cosmo.h()

    def sigma8(self) -> float:
        return self._cosmo.sigma8()

    # ------------------------------------------------------------------ #
    def build_tables(self, lin_norm, a=None, species_map=None):
        """TransferTables from this CLASS run, disk-cached like the
        reference's .reusable/class store (commons.py:5593
        get_reusable_filename; cache key = the class params hash)."""
        import os

        from concept_tpu_torch.cosmology.boltzmann import tabulate_class

        cache = self._cache_file + ".npz"
        if os.path.exists(cache):
            return load_tables(cache)
        tables = tabulate_class(self, lin_norm, a=a, species_map=species_map)
        save_tables(tables, cache)
        return tables


def save_tables(tables, path: str) -> None:
    """Serialize a TransferTables to .npz (the disk-cache format)."""
    import numpy as np

    payload = {"k": tables.k, "a": tables.a, "gauge": np.str_(tables.gauge)}
    for (species, var), tab in tables.tables.items():
        payload[f"tab::{species}::{var}"] = tab
    for name, tab in tables.aux.items():
        payload[f"aux::{name}"] = tab
    import os

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **payload)


def load_tables(path: str):
    import numpy as np
    from concept_tpu_torch.cosmology.boltzmann import TransferTables

    z = np.load(path, allow_pickle=False)
    tables, aux = {}, {}
    for key in z.files:
        if key.startswith("tab::"):
            _, species, var = key.split("::")
            tables[(species, var)] = z[key]
        elif key.startswith("aux::"):
            aux[key.split("::", 1)[1]] = z[key]
    return TransferTables(k=z["k"], a=z["a"], tables=tables, aux=aux,
                          gauge=str(z["gauge"]))
