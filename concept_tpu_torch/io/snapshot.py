"""Snapshot I/O: CONCEPT-HDF5 and GADGET-2 (read and write), TIPSY (read)
(port of concept_tpu/io/snapshot.py; reference src/snapshot.py:
ConceptSnapshot :53, GadgetSnapshot :639, TipsySnapshot :2643, type
detection :3206).

Host-side: numpy and ``h5py`` (imported inside the functions that need
it).  A state to save may hold tensors on any device or numpy arrays;
each tensor crosses to the host once per file (one ``.cpu()`` per
array), and the files are written chunk by chunk from that copy, so no
float64 copy of a whole array is built.  Loading returns numpy arrays;
``run`` moves them to the device.

The files are the JAX package's, byte for byte where the format fixes
the bytes: the CONCEPT-HDF5 layout (root attrs {'unit time', 'unit
length', 'unit mass', 'H0', 'a', 'boxsize', 'Ωb', 'Ωcdm'}, groups
components/<name> with attrs {'species', 'mass', 'N'}, float64 (N, 3)
datasets pos/mom, int64 ids, int8 rungs where the state has them) and
the GADGET-2 header, block markers and uint32 ids.  A fluid component's
group holds attrs {'species', 'gridsize', 'boltzmann_order',
'boltzmann_closure', 'w'} and float64 datasets ϱ (n, n, n), J
(3, n, n, n), 𝒫 and ς (6, n, n, n) where the state has them.

Momentum conventions:
  CONCEPT: mom = a²·m·ẋ (internal = file)
  GADGET-2: the file stores u, with peculiar velocity v = u·√a
"""

from __future__ import annotations

import math
import os
import struct
from dataclasses import dataclass

import numpy as np

from concept_tpu_torch.components import ComponentSpec, FluidState, ParticleState
_CHUNK_ROWS = 1 << 20  # rows converted and written at a time


@dataclass
class SnapshotMeta:
    a: float
    boxsize: float
    H0: float
    Omega_b: float
    Omega_cdm: float
    unit_length: str = "Mpc"
    unit_time: str = "Gyr"
    unit_mass: str = "10**10 m_sun"


def _host(x) -> np.ndarray:
    """A tensor (any device) or array → numpy, copying a device tensor to
    the host once and a host one not at all."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _chunks(arr: np.ndarray, convert):
    """``convert`` applied to ``arr`` _CHUNK_ROWS rows at a time."""
    for s in range(0, max(len(arr), 1), _CHUNK_ROWS):
        yield convert(arr[s:s + _CHUNK_ROWS])


def _is_fluid(spec, state) -> bool:
    return getattr(spec, "representation", "particles") == "fluid" or not hasattr(state, "pos")


# --------------------------------------------------------------------- #
# CONCEPT HDF5
# --------------------------------------------------------------------- #
def save_concept(filename: str, meta: SnapshotMeta, components: dict,
                 select: dict | None = None):
    """components: {name: (ComponentSpec, ParticleState | FluidState)}.
    ``select`` is the snapshot_select save mask: {component name or
    'all': bool or {variable or 'all': bool}} (reference snapshot_select
    semantics, param/example_explanatory:37-57)."""
    import h5py

    def want(name, var):
        if not select:
            return True
        sel = select.get(name, select.get("all", True))
        if isinstance(sel, dict):
            return bool(sel.get(var, sel.get("all", True)))
        return bool(sel)

    def write(g, var, x, dtype):
        arr = _host(x)
        ds = g.create_dataset(var, shape=arr.shape, dtype=dtype)
        for s in range(0, len(arr), _CHUNK_ROWS):
            ds[s:s + _CHUNK_ROWS] = arr[s:s + _CHUNK_ROWS].astype(dtype)

    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    with h5py.File(filename, "w") as f:
        f.attrs["unit time"] = meta.unit_time
        f.attrs["unit length"] = meta.unit_length
        f.attrs["unit mass"] = meta.unit_mass
        f.attrs["H0"] = meta.H0
        f.attrs["a"] = meta.a
        f.attrs["boxsize"] = meta.boxsize
        f.attrs["Ωb"] = meta.Omega_b
        f.attrs["Ωcdm"] = meta.Omega_cdm
        for name, (spec, state) in components.items():
            g = f.create_group(f"components/{name}")
            g.attrs["species"] = spec.species
            if _is_fluid(spec, state):
                g.attrs["gridsize"] = spec.gridsize or _host(state.varrho).shape[0]
                g.attrs["boltzmann_order"] = spec.boltzmann_order
                g.attrs["boltzmann_closure"] = spec.boltzmann_closure
                g.attrs["w"] = spec.w
                for var, x in (("ϱ", state.varrho), ("J", state.J), ("𝒫", state.P),
                               ("ς", state.sigma)):
                    if x is not None and want(name, var):
                        write(g, var, x, np.float64)
                continue
            g.attrs["mass"] = spec.mass
            g.attrs["N"] = spec.N
            if want(name, "pos"):
                write(g, "pos", state.pos, np.float64)
            if want(name, "mom"):
                write(g, "mom", state.mom, np.float64)
            if state.ids is not None and want(name, "ids"):
                write(g, "ids", state.ids, np.int64)
            if getattr(state, "rungs", None) is not None and want(name, "rungs"):
                write(g, "rungs", state.rungs, np.int8)
    return filename


def load_concept(filename: str):
    """→ (SnapshotMeta, {name: (ComponentSpec, ParticleState or
    FluidState of numpy arrays)})."""
    import h5py

    components = {}
    with h5py.File(filename, "r") as f:
        meta = SnapshotMeta(
            a=float(f.attrs["a"]),
            boxsize=float(f.attrs["boxsize"]),
            H0=float(f.attrs["H0"]),
            Omega_b=float(f.attrs["Ωb"]),
            Omega_cdm=float(f.attrs["Ωcdm"]),
            unit_length=str(f.attrs.get("unit length", "Mpc")),
            unit_time=str(f.attrs.get("unit time", "Gyr")),
            unit_mass=str(f.attrs.get("unit mass", "10**10 m_sun")),
        )
        for name, g in f["components"].items():
            if "gridsize" in g.attrs:  # a fluid component
                spec = ComponentSpec(
                    name=name, species=str(g.attrs["species"]), representation="fluid",
                    gridsize=int(g.attrs["gridsize"]), w=float(g.attrs.get("w", 0.0)),
                    boltzmann_order=int(g.attrs.get("boltzmann_order", 1)),
                    boltzmann_closure=str(g.attrs.get("boltzmann_closure", "truncate")))
                components[name] = (spec, FluidState(*(
                    np.asarray(g[var], dtype=np.float64) if var in g else None
                    for var in ("ϱ", "J", "𝒫", "ς"))))
                continue
            spec = ComponentSpec(name=name, species=str(g.attrs["species"]),
                                 N=int(g.attrs["N"]), mass=float(g.attrs["mass"]))
            state = ParticleState(
                pos=np.asarray(g["pos"], dtype=np.float64),
                mom=np.asarray(g["mom"], dtype=np.float64),
                ids=np.asarray(g["ids"]) if "ids" in g else None,
                rungs=np.asarray(g["rungs"]) if "rungs" in g else None,
            )
            components[name] = (spec, state)
    return meta, components


def is_concept_snapshot(filename: str) -> bool:
    try:
        import h5py

        with h5py.File(filename, "r") as f:
            return "Ωcdm" in f.attrs
    except (OSError, ImportError):
        return False


# --------------------------------------------------------------------- #
# GADGET-2
# --------------------------------------------------------------------- #
_GADGET_HEADER = struct.Struct("<6I6dddii6Iiiddddii6Ii60x")  # 256 bytes


def _gadget_header_bytes(npart, masses, time, redshift, boxsize,
                         omega0, omega_lambda, hubble_param, num_files=1,
                         nall=None, overrides: dict | None = None):
    """``overrides``: reference gadget_snapshot_params['header'] field
    overrides by GADGET header-field name (snapshot.py:673-702)."""
    nall_arr = list(npart)
    if nall is not None:
        nall_arr = [0, int(nall), 0, 0, 0, 0]
    fields = {
        "Time": time, "Redshift": redshift, "BoxSize": boxsize,
        "Omega0": omega0, "OmegaLambda": omega_lambda,
        "HubbleParam": hubble_param, "NumFilesPerSnapshot": num_files,
        "FlagSfr": 0, "FlagFeedback": 0, "FlagCooling": 0,
        "FlagAge": 0, "FlagMetals": 0, "FlagEntropyICs": 0,
    }
    for key, val in (overrides or {}).items():
        if key not in fields:
            raise ValueError(f"unknown GADGET header field {key!r}")
        fields[key] = val
    return _GADGET_HEADER.pack(
        *npart, *masses, fields["Time"], fields["Redshift"],
        fields["FlagSfr"], fields["FlagFeedback"], *nall_arr,
        fields["FlagCooling"], fields["NumFilesPerSnapshot"],
        fields["BoxSize"], fields["Omega0"], fields["OmegaLambda"],
        fields["HubbleParam"], fields["FlagAge"], fields["FlagMetals"],
        *([0] * 6), fields["FlagEntropyICs"],
    )


def _gadget_units(H0: float, units):
    """(h, kpc/h, 10¹⁰ m_sun/h, km/s) in internal units."""
    h = H0 / (100 * units.km / (units.s * units.Mpc))
    return h, units.kpc / h, 1e10 * units.m_sun / h, units.km / units.s


def _write_block(f, name: str, nbytes: int, payloads, snapformat: int):
    """One GADGET block of ``nbytes`` from the byte strings ``payloads``
    (format 2 puts a named marker block before it)."""
    if snapformat == 2:
        f.write(struct.pack("<I", 8))
        f.write(name.encode().ljust(4))
        f.write(struct.pack("<I", nbytes + 8))
        f.write(struct.pack("<I", 8))
    f.write(struct.pack("<I", nbytes))
    written = 0
    for p in payloads:
        f.write(p)
        written += len(p)
    if written != nbytes:
        raise RuntimeError(f"GADGET block {name!r}: wrote {written} of {nbytes} bytes")
    f.write(struct.pack("<I", nbytes))


def save_gadget(filename: str, meta: SnapshotMeta, spec: ComponentSpec,
                state: ParticleState, units, snapformat: int = 2,
                single_precision: bool = True, num_files: int = 1,
                nall: int | None = None, header_overrides: dict | None = None):
    """Write a GADGET-2 snapshot (particle type 1 = halo/cdm).  GADGET
    units: kpc/h (length), 10¹⁰ m_sun/h (mass), km/s (velocity, u =
    v_peculiar/√a).  Reference: snapshot.py:639-2642."""
    h, kpc_h, msun10_h, kms = _gadget_units(meta.H0, units)
    a = meta.a
    dtype = np.float32 if single_precision else np.float64
    N = spec.N
    pos = _host(state.pos)
    mom = _host(state.mom)
    ids = _host(state.ids) if state.ids is not None else np.arange(N, dtype=np.uint32)
    header = _gadget_header_bytes(
        [0, N, 0, 0, 0, 0], [0.0, spec.mass / msun10_h, 0.0, 0.0, 0.0, 0.0],
        a, 1 / a - 1, meta.boxsize / kpc_h, meta.Omega_b + meta.Omega_cdm,
        1 - meta.Omega_b - meta.Omega_cdm, h,
        num_files=num_files, nall=nall if nall is not None else N,
        overrides=header_overrides,
    )
    vec_bytes = N * 3 * np.dtype(dtype).itemsize
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    with open(filename, "wb") as f:
        _write_block(f, "HEAD", len(header), [header], snapformat)
        _write_block(f, "POS ", vec_bytes, _chunks(
            pos, lambda c: (c.astype(np.float64) / kpc_h).astype(dtype).tobytes()),
            snapformat)
        # u = v_pec/√a = mom/(a^1.5 m)
        _write_block(f, "VEL ", vec_bytes, _chunks(
            mom, lambda c: (c.astype(np.float64) / (a**1.5 * spec.mass) / kms)
            .astype(dtype).tobytes()), snapformat)
        _write_block(f, "ID  ", 4 * N, _chunks(
            ids, lambda c: c.astype(np.uint32).tobytes()), snapformat)
    return filename


def save_gadget_components(filename: str, meta: SnapshotMeta, comps: dict, units,
                           types: dict | None = None, snapformat: int = 2,
                           single_precision: bool = True):
    """Write several particle components as distinct GADGET particle
    types.  ``types``: {name: GADGET type 0-5}; by default 1 (halo) for
    the first component and 2, 3, 4, 5, 0 for the rest in order.  The
    POS/VEL/ID blocks hold the types in type order."""
    h, kpc_h, msun10_h, kms = _gadget_units(meta.H0, units)
    a = meta.a
    dtype = np.float32 if single_precision else np.float64
    if types is None:
        pool = [1, 2, 3, 4, 5, 0]
        types = {name: pool.pop(0) for name in comps}
    by_type = sorted(comps.items(), key=lambda kv: types[kv[0]])
    npart = [0] * 6
    masses = [0.0] * 6
    pos_parts, vel_parts, id_parts = [], [], []
    id_offset = 0
    for name, (spec, state) in by_type:
        t = types[name]
        npart[t] = spec.N
        masses[t] = spec.mass / msun10_h
        pos_parts.append(_host(state.pos).astype(np.float64) / kpc_h)
        vel_parts.append(_host(state.mom).astype(np.float64) / (a**1.5 * spec.mass) / kms)
        id_parts.append(_host(state.ids).astype(np.uint32) if state.ids is not None
                        else np.arange(id_offset, id_offset + spec.N, dtype=np.uint32))
        id_offset += spec.N
    header = _gadget_header_bytes(
        npart, masses, a, 1 / a - 1, meta.boxsize / kpc_h,
        meta.Omega_b + meta.Omega_cdm, 1 - meta.Omega_b - meta.Omega_cdm, h,
        num_files=1, nall=None)
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    with open(filename, "wb") as f:
        for name, parts in (("HEAD", [header]),
                            ("POS ", [np.concatenate(pos_parts).astype(dtype).tobytes()]),
                            ("VEL ", [np.concatenate(vel_parts).astype(dtype).tobytes()]),
                            ("ID  ", [np.concatenate(id_parts).tobytes()])):
            _write_block(f, name, len(parts[0]), parts, snapformat)
    return filename


def save_gadget_multifile(filename_base: str, meta: SnapshotMeta, spec: ComponentSpec,
                          state: ParticleState, units, particles_per_file: int,
                          snapformat: int = 2, single_precision: bool = True,
                          header_overrides: dict | None = None):
    """Split a component over <base>.0, <base>.1, ... files of at most
    ``particles_per_file`` particles (one file keeps the base name;
    reference gadget_snapshot_params['particles per file'])."""
    N = spec.N
    n_files = max(1, -(-N // particles_per_file))
    ids = state.ids if state.ids is not None else np.arange(N)
    files = []
    for i in range(n_files):
        sl = slice(i * particles_per_file, min((i + 1) * particles_per_file, N))
        sub_spec = ComponentSpec(name=spec.name, species=spec.species,
                                 N=sl.stop - sl.start, mass=spec.mass)
        sub_state = ParticleState(pos=state.pos[sl], mom=state.mom[sl], ids=ids[sl])
        fn = f"{filename_base}.{i}" if n_files > 1 else filename_base
        save_gadget(fn, meta, sub_spec, sub_state, units, snapformat=snapformat,
                    single_precision=single_precision, num_files=n_files, nall=N,
                    header_overrides=header_overrides)
        files.append(fn)
    return files


def load_gadget_multifile(filename_base: str, units):
    """Load <base>.0, <base>.1, ... and concatenate them (the base name
    alone where no .0 exists)."""
    files = []
    while os.path.exists(f"{filename_base}.{len(files)}"):
        files.append(f"{filename_base}.{len(files)}")
    if not files:
        return load_gadget(filename_base, units)
    meta, spec0, poss, moms, idss = None, None, [], [], []
    for fn in files:
        meta, comps = load_gadget(fn, units)
        (spec0, state), = comps.values()
        poss.append(state.pos)
        moms.append(state.mom)
        idss.append(state.ids)
    spec = ComponentSpec(name=spec0.name, species=spec0.species,
                         N=sum(len(p) for p in poss), mass=spec0.mass)
    state = ParticleState(pos=np.concatenate(poss), mom=np.concatenate(moms),
                          ids=np.concatenate(idss))
    return meta, {spec.name: (spec, state)}


def _read_block(f, filename: str):
    """(name or None, payload) of the next GADGET block (SnapFormat 1 or
    2)."""
    def u32():
        raw = f.read(4)
        if len(raw) != 4:
            raise ValueError(f"{filename}: truncated GADGET file")
        return struct.unpack("<I", raw)[0]

    size = u32()
    name = None
    if size == 8:  # SnapFormat 2 marker: name, size of the next block, 8
        name = f.read(4).decode().strip()
        u32()
        u32()
        size = u32()
    payload = f.read(size)
    if len(payload) != size or u32() != size:
        raise ValueError(f"{filename}: corrupt GADGET block {name!r}")
    return name, payload


def load_gadget(filename: str, units):
    """Read a single GADGET-2 file (SnapFormat 1 or 2, 32- or 64-bit
    data, uint32 or uint64 ids, an optional MASS block): one component
    per populated particle type."""
    with open(filename, "rb") as f:
        _, header = _read_block(f, filename)
        vals = _GADGET_HEADER.unpack(header.ljust(256, b"\0")[:_GADGET_HEADER.size])
        npart, masses = vals[0:6], vals[6:12]
        time_ = vals[12]
        # Nall (16-21), FlagCooling (22), NumFiles (23), BoxSize (24),
        # Omega0 (25), OmegaLambda (26), HubbleParam (27)
        boxsize_g, omega0, hubble = vals[24], vals[25], vals[27]
        N = int(sum(npart))
        _, pos_raw = _read_block(f, filename)
        _, vel_raw = _read_block(f, filename)
        _, ids_raw = _read_block(f, filename)
        fdtype = np.float32 if len(pos_raw) // (3 * N) == 4 else np.float64
        pos = np.frombuffer(pos_raw, fdtype).reshape(N, 3).astype(np.float64)
        vel = np.frombuffer(vel_raw, fdtype).reshape(N, 3).astype(np.float64)
        del pos_raw, vel_raw
        ids = np.frombuffer(ids_raw, np.uint32 if len(ids_raw) == 4 * N else np.uint64)
        # the MASS block: present iff a populated type has header mass 0;
        # it holds those particles' masses in type order
        n_mass = sum(int(npart[t]) for t in range(6) if npart[t] and masses[t] == 0)
        mass_arr = None
        if n_mass:
            _, mass_raw = _read_block(f, filename)
            mdtype = np.float32 if len(mass_raw) == 4 * n_mass else np.float64
            mass_arr = np.frombuffer(mass_raw, mdtype).astype(np.float64)
            if mass_arr.size != n_mass:
                raise ValueError(f"{filename}: MASS block holds {mass_arr.size} "
                                 f"masses, the header {n_mass}")
    kpc_h = units.kpc / hubble
    msun10_h = 1e10 * units.m_sun / hubble
    kms = units.km / units.s
    a = time_
    meta = SnapshotMeta(a=a, boxsize=boxsize_g * kpc_h,
                        H0=100 * hubble * units.km / (units.s * units.Mpc),
                        Omega_b=0.0, Omega_cdm=omega0)
    type_names = ("gas", "halo", "disk", "bulge", "stars", "bndry")
    comps = {}
    start = mcur = 0
    for t in range(6):
        n_t = int(npart[t])
        if n_t == 0:
            continue
        if masses[t] == 0 and mass_arr is not None:
            # per-particle masses: momenta take each particle's own, the
            # component its mean (with a warning where they vary)
            m_t = mass_arr[mcur:mcur + n_t] * msun10_h
            mcur += n_t
            mass = float(np.mean(m_t))
            if not np.all(m_t == m_t[0]):
                from concept_tpu_torch.utils.terminal import warn

                warn(f"GADGET type '{type_names[t]}' has per-particle masses; "
                     f"momenta are exact, the component mass is the mean")
            mom_t = vel[start:start + n_t] * kms * (a**1.5) * m_t[:, None]
        else:
            mass = masses[t] * msun10_h
            mom_t = vel[start:start + n_t] * kms * (a**1.5) * mass
        name = f"GADGET {type_names[t]}"
        comps[name] = (ComponentSpec(name=name, species="matter", N=n_t, mass=mass),
                       ParticleState(pos=pos[start:start + n_t] * kpc_h, mom=mom_t,
                                     ids=ids[start:start + n_t]))
        start += n_t
    return meta, comps


def is_gadget_snapshot(filename: str) -> bool:
    try:
        with open(filename, "rb") as f:
            head = f.read(8)
        size = struct.unpack_from("<I", head, 0)[0]
        return size == 8 and head[4:8] == b"HEAD" or size == 256
    except (OSError, struct.error):
        return False


# --------------------------------------------------------------------- #
# TIPSY (read only, as the reference: snapshot.py:2643-3044)
# --------------------------------------------------------------------- #
_TIPSY_HEADER_FMT = "{e}d i i i i i 4x"  # time nbodies ndim nsph ndark nstar


def _tipsy_header(raw: bytes):
    """(time, nbodies, ndim, nsph, ndark, nstar, endianness), probing
    both endiannesses by the ndim check (reference read_header,
    snapshot.py:2770-2789)."""
    for e in ("<", ">"):
        s = struct.Struct(_TIPSY_HEADER_FMT.format(e=e))
        vals = s.unpack(raw[: s.size])
        if vals[2] in (1, 2, 3):
            return (*vals, e)
    raise ValueError("not a TIPSY snapshot (no endianness matches)")


def is_tipsy_snapshot(filename: str) -> bool:
    try:
        with open(filename, "rb") as f:
            head = f.read(32)
        t, nbodies, ndim, nsph, ndark, nstar, _ = _tipsy_header(head)
        return ndim == 3 and 0 < nbodies < 2**40 and nsph + ndark + nstar == nbodies
    except (OSError, ValueError, struct.error):
        return False


def load_tipsy(filename: str, units, boxsize: float | None = None,
               H0: float | None = None):
    """Read the dark-matter particles of a TIPSY file (little- or
    big-endian).  TIPSY units (reference snapshot.py:2930-2985):
    positions in [−0.5, 0.5] map to (0.5 + x)·boxsize, the mass unit is
    3H₀²/(8πG)·boxsize³ and the momentum unit boxsize·H₀·√(3/(8π))·a²·
    mass.  The file stores neither boxsize nor H₀: without them the
    dimensionless values are returned (unit box, unit-H₀ momenta).
    Per-particle masses collapse to their mean, with a warning.  A dark
    particle is mass, pos[3], vel[3], eps, phi (9 × f32)."""
    from concept_tpu_torch.units import constants
    from concept_tpu_torch.utils.terminal import warn

    with open(filename, "rb") as f:
        raw = f.read()
    t, nbodies, ndim, nsph, ndark, nstar, e = _tipsy_header(raw[:32])
    off = 32 + nsph * 12 * 4
    dark = np.frombuffer(raw, dtype=np.dtype(f"{e}f4"), count=ndark * 9,
                         offset=off).reshape(ndark, 9).astype(np.float64)
    masses = dark[:, 0]
    mass = float(masses[0])
    if np.unique(masses).size > 1:
        mass = float(np.mean(masses))
        warn("TIPSY particles have independent masses; using the mean "
             "particle mass (as the reference does)")
    L = boxsize if boxsize is not None else 1.0
    a = t
    if H0 is not None:
        mass = mass * (3 * H0**2 / (8 * math.pi * constants.G_Newton) * L**3)
        mom_unit = L * H0 * math.sqrt(3 / (8 * math.pi)) * a**2 * mass
    else:
        mom_unit = a**2 * mass
    meta = SnapshotMeta(a=a, boxsize=L, H0=H0 if H0 is not None else 0.0,
                        Omega_b=0.0, Omega_cdm=0.0)
    spec = ComponentSpec(name="TIPSY dark", species="matter", N=ndark, mass=mass)
    state = ParticleState(pos=(dark[:, 1:4] + 0.5) * L, mom=dark[:, 4:7] * mom_unit,
                          ids=np.arange(ndark))
    return meta, {spec.name: (spec, state)}


# --------------------------------------------------------------------- #
# Dispatch (reference snapshot.py:3206 get_snapshot_type)
# --------------------------------------------------------------------- #
def snapshot_type(filename: str) -> str | None:
    """'concept', 'gadget', 'tipsy' or None; a GADGET base name whose
    files are <base>.0, ... counts as its first file."""
    probe = filename if os.path.exists(filename) else filename + ".0"
    if not os.path.exists(probe):
        return None
    if is_concept_snapshot(probe):
        return "concept"
    if is_gadget_snapshot(probe):
        return "gadget"
    if is_tipsy_snapshot(probe):
        return "tipsy"
    return None


def load(filename: str, units=None, boxsize: float | None = None,
         H0: float | None = None):
    """Load any supported snapshot.  ``boxsize``/``H0``: the simulation's,
    for formats that do not store them (TIPSY)."""
    if units is None:
        from concept_tpu_torch.units import units as default_units

        units = default_units
    kind = snapshot_type(filename)
    if kind == "concept":
        return load_concept(filename)
    if kind == "gadget":
        if not os.path.exists(filename) or os.path.exists(filename + ".0"):
            return load_gadget_multifile(filename, units)
        return load_gadget(filename, units)
    if kind == "tipsy":
        return load_tipsy(filename, units, boxsize=boxsize, H0=H0)
    raise ValueError(f"unrecognized snapshot format: {filename}")
