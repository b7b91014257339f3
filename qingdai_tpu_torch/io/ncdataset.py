"""netCDF4.Dataset compatibility layer (the port's copy of
``qingdai_tpu/io/ncdataset.py``, held equal to it by
``tests/test_torch_repairs.py``).

The reference persists all state as NetCDF (restarts, topography, hydrology
network, ecology, plankton — SURVEY.md §5.4). This environment ships h5py but
not netCDF4, so this module provides ``Dataset`` with the subset of the
netCDF4 API the framework uses (createDimension/createVariable/variables/
__getitem__/setncattr/getncattr/ncattrs), backed by the real netCDF4 library
when importable and otherwise by h5py.

The h5py writer produces the actual **netCDF-4 on-disk layout** (the same
convention h5netcdf implements and the netCDF-C library requires, so the
files open as valid NETCDF4 in netCDF4-python/xarray — not just "HDF5 with
arrays"):

- every dimension is an HDF5 *dimension scale*: a coordinate variable of the
  same name doubles as the scale (``CLASS=DIMENSION_SCALE``, ``NAME`` = the
  dimension name); a dimension without a coordinate variable gets a stub
  dataset whose NAME is netCDF-C's canonical
  ``"This is a netCDF dimension but not a netCDF variable.%10d" % size``
  (libsrc4 ``DIM_WITHOUT_VARIABLE`` marker);
- each data variable's axes carry ``DIMENSION_LIST`` object references to
  their scales (h5py ``dims[i].attach_scale``), with the matching
  ``REFERENCE_LIST`` back-references on the scales;
- each dimension dataset records its creation order in ``_Netcdf4Dimid``.

The layout is asserted structurally by tests/test_netcdf_interchange.py via
h5py's independent implementation of the HDF5 dimension-scale spec.
"""

from __future__ import annotations

import numpy as np

try:  # pragma: no cover - depends on environment
    from netCDF4 import Dataset as _NC4Dataset
    HAVE_NETCDF4 = True
except ImportError:
    _NC4Dataset = None
    HAVE_NETCDF4 = False

import h5py

_DTYPE_MAP = {
    "f4": np.float32, "f8": np.float64,
    "i1": np.int8, "i2": np.int16, "i4": np.int32, "i8": np.int64,
    "u1": np.uint8, "u2": np.uint16, "u4": np.uint32, "u8": np.uint64,
}


class _H5Variable:
    def __init__(self, group, name, dtype, dims, shape, zlib=False, complevel=4):
        kw = {}
        if zlib:
            kw = dict(compression="gzip", compression_opts=int(complevel))
        if shape == ():
            self.ds = group.create_dataset(name, shape=(), dtype=dtype)
        else:
            self.ds = group.create_dataset(name, shape=shape, dtype=dtype, **kw)
        self.ds.attrs["_nc_dims"] = np.array([d.encode() for d in dims])
        self._name = name

    def __setitem__(self, key, value):
        if self.ds.shape == ():
            self.ds[()] = np.asarray(value)
        else:
            self.ds[key] = np.asarray(value)

    def __getitem__(self, key):
        return self.ds[key]

    def __setattr__(self, name, value):
        if name in ("ds", "_name"):
            object.__setattr__(self, name, value)
        else:  # variable attributes (units, long_name, ...)
            self.ds.attrs[name] = value

    def __getattr__(self, name):
        try:
            return self.ds.attrs[name]
        except KeyError as e:
            raise AttributeError(name) from e


class _H5ReadVariable:
    def __init__(self, ds):
        self._ds = ds

    def __getitem__(self, key):
        v = self._ds[key] if self._ds.shape != () else self._ds[()]
        arr = np.asarray(v)
        return arr

    @property
    def shape(self):
        return self._ds.shape

    @property
    def data(self):
        return np.asarray(self._ds[()] if self._ds.shape == () else self._ds[:])

    def __getattr__(self, name):
        try:
            return self._ds.attrs[name]
        except KeyError as e:
            raise AttributeError(name) from e


class _H5Dataset:
    """h5py-backed netCDF4.Dataset lookalike (write + read)."""

    def __init__(self, path, mode="r"):
        self._f = h5py.File(path, mode)
        self._dims = {}
        self._mode = mode
        self.variables = {}
        if mode == "r":
            for k, v in self._f.items():
                if not isinstance(v, h5py.Dataset):
                    continue
                # netCDF-4 semantics: a dimension-only stub dataset (the
                # DIM_WITHOUT_VARIABLE marker) is not a variable
                nm = v.attrs.get("NAME")
                if isinstance(nm, bytes):
                    nm = nm.decode(errors="replace")
                if isinstance(nm, str) and nm.startswith(
                        "This is a netCDF dimension but not a netCDF"):
                    continue
                self.variables[k] = _H5ReadVariable(v)

    # --- write API ---
    def createDimension(self, name, size=None):
        self._dims[name] = size

    def createVariable(self, name, dtype, dims=(), zlib=False, complevel=4,
                       **kw):
        if isinstance(dims, str):
            dims = (dims,)
        np_dtype = _DTYPE_MAP.get(dtype, dtype)
        shape = tuple(self._dims[d] for d in dims)
        var = _H5Variable(self._f, name, np_dtype, dims, shape, zlib, complevel)
        self.variables[name] = var
        return var

    def setncattr(self, name, value):
        self._f.attrs[name] = value

    def getncattr(self, name):
        v = self._f.attrs[name]
        return v.decode() if isinstance(v, bytes) else v

    def ncattrs(self):
        return list(self._f.attrs.keys())

    def __setattr__(self, name, value):
        if name.startswith("_") or name == "variables":
            object.__setattr__(self, name, value)
        else:
            self._f.attrs[name] = value

    def __getattr__(self, name):
        try:
            v = self._f.attrs[name]
            return v.decode() if isinstance(v, bytes) else v
        except KeyError as e:
            raise AttributeError(name) from e

    def __getitem__(self, name):
        return self.variables[name]

    def _wire_dimension_scales(self):
        """Finalize the netCDF-4 dimension-scale layout (module docstring):
        promote coordinate variables to scales, create DIM_WITHOUT_VARIABLE
        stubs, attach DIMENSION_LIST references on every data variable."""
        dim_ds = {}
        for i, (name, size) in enumerate(self._dims.items()):
            if name in self.variables:
                d = self.variables[name].ds
                if d.shape == ():
                    continue  # scalar can't be a scale; dim stays phony
                d.make_scale(name)
            else:
                n = int(size) if size else 0
                d = self._f.create_dataset(name, shape=(n,), dtype="f4")
                d.make_scale(
                    "This is a netCDF dimension but not a netCDF "
                    "variable.%10d" % n)
            d.attrs["_Netcdf4Dimid"] = np.int32(i)
            dim_ds[name] = d
        for name, var in self.variables.items():
            dims = [x.decode() if isinstance(x, bytes) else str(x)
                    for x in var.ds.attrs.get("_nc_dims", [])]
            for ax, dname in enumerate(dims):
                if dname == name:
                    continue  # a coordinate variable is its own scale
                if dname in dim_ds and ax < len(var.ds.dims):
                    var.ds.dims[ax].attach_scale(dim_ds[dname])

    def close(self):
        if self._mode != "r":
            try:
                self._wire_dimension_scales()
            except (OSError, RuntimeError, ValueError) as e:  # never lose data over layout
                import warnings
                warnings.warn(f"netCDF-4 dimension-scale wiring failed: {e}")
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def Dataset(path, mode="r", *args, **kwargs):
    """Open a dataset with netCDF4 when available, else the h5py shim.

    Reading prefers whichever backend can open the file (reference-produced
    NETCDF4 files are HDF5, so the shim reads them too; NETCDF3 classic files
    require the real library)."""
    if HAVE_NETCDF4:
        return _NC4Dataset(path, mode, *args, **kwargs)
    return _H5Dataset(path, mode)
