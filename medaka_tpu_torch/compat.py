"""Interop with reference medaka artifacts (pickled metadata, checkpoints).

Counterpart of ``medaka_tpu/compat.py``. Reference medaka pickles its
feature encoders, label schemes and a model factory partial into HDF5
files (``meta/``) and model tarballs (``meta.pkl`` beside a torch
``weights.pt``). This module unpickles them without medaka installed,
standing a stub class in for every ``medaka.*`` object, then maps the
stubs onto the port's encoders, label schemes and ``{type, kwargs}``
model dicts.

Unlike ``medaka_tpu``, nothing here falls back: a pickled object whose
class the port lacks, or a model factory it cannot read, raises an error
naming it.
"""
from __future__ import annotations

import functools
import inspect
import io
import pickle
import tarfile
from typing import Any, Dict, Optional


class MedakaStub:
    """Placeholder standing in for any pickled medaka object.

    Class-level defaults matter: pickle NEWOBJ constructs instances via
    ``cls.__new__`` without running ``__init__``.
    """

    _medaka_name_ = "unknown"
    _args = ()
    _kwargs: Dict = {}
    _state: Dict = {}

    def __init__(self, *args, **kwargs):
        self._args = args
        self._kwargs = kwargs
        self._state = {}

    def __setstate__(self, state):
        if isinstance(state, dict):
            self._state = state
        else:
            self._state = {"__state__": state}

    def __call__(self, *args, **kwargs):
        # a pickled function stub called (e.g. by a REDUCE)
        call = MedakaStub()
        call._medaka_name_ = self._medaka_name_
        call._args = args
        call._kwargs = kwargs
        return call


_STUB_CACHE: Dict[str, type] = {}


def _stub_class(module: str, name: str) -> type:
    full = "{}.{}".format(module, name)
    if full not in _STUB_CACHE:
        _STUB_CACHE[full] = type(
            name, (MedakaStub,), {"_medaka_name_": full})
    return _STUB_CACHE[full]


#: the globals besides medaka's that a reference pickle may name: plain
#: containers and numpy arrays, dtypes and scalar types
SAFE_GLOBALS = {
    "builtins": {"set", "frozenset", "tuple", "list", "dict", "slice",
                 "range", "complex", "bytearray"},
    "collections": {"OrderedDict", "defaultdict"},
    "copyreg": {"_reconstructor"},
    "functools": {"partial"},
    "numpy": {"dtype", "ndarray", "bool_", "int8", "int16", "int32",
              "int64", "uint8", "uint16", "uint32", "uint64", "float16",
              "float32", "float64"},
    "numpy.core.multiarray": {"_reconstruct", "scalar"},
    "numpy._core.multiarray": {"_reconstruct", "scalar"},
}


class MedakaUnpickler(pickle.Unpickler):
    """Unpickler replacing medaka classes and functions with stubs.

    Any other global outside :data:`SAFE_GLOBALS` raises
    ``pickle.UnpicklingError`` naming it, so a pickle cannot call into
    arbitrary modules (``medaka_tpu``'s unpickler resolves any global).
    """

    def find_class(self, module, name):
        if module.split(".")[0] in ("medaka", "libmedaka"):
            cls = _stub_class(module, name)
            # lowercase names are functions: return a callable capture
            return cls() if name[0].islower() else cls
        if name not in SAFE_GLOBALS.get(module, ()):
            raise pickle.UnpicklingError(
                "the reference pickle names {}.{}, which medaka_tpu_torch "
                "does not unpickle".format(module, name))
        return super().find_class(module, name)


def medaka_loads(data) -> Any:
    """Unpickle reference-medaka bytes (or a buffer) into stubs."""
    return MedakaUnpickler(io.BytesIO(bytes(data))).load()


def _stub_name(obj) -> Optional[str]:
    if isinstance(obj, MedakaStub):
        return obj._medaka_name_.rsplit(".", 1)[-1]
    return None


def _filter_kwargs(cls, kwargs: Dict) -> Dict:
    params = inspect.signature(cls.__init__).parameters
    return {k: v for k, v in kwargs.items() if k in params}


def _convert_stub(obj, registry: Dict[str, type], what: str):
    """A stub's class from ``registry``, built from the stub's pickled
    state; None stays None; anything else raises."""
    if obj is None:
        return None
    name = _stub_name(obj)
    if name is None:
        raise ValueError("Cannot convert the pickled {} {!r}: not a medaka "
                         "object".format(what, obj))
    cls = registry.get(name)
    if cls is None:
        raise ValueError(
            "The pickled {} {} is not ported to medaka_tpu_torch (ported: "
            "{}).".format(what, obj._medaka_name_, ", ".join(registry)))
    state = dict(obj._state)
    if isinstance(state.get("dtypes"), list):
        state["dtypes"] = tuple(state["dtypes"])
    return cls(**_filter_kwargs(cls, state))


def convert_feature_encoder(obj):
    """Map a pickled medaka feature encoder (stub) onto the port's."""
    from medaka_tpu_torch import features
    return _convert_stub(obj, features.feature_encoders, "feature encoder")


def convert_label_scheme(obj):
    """Map a pickled medaka label scheme (stub) onto the port's."""
    from medaka_tpu_torch import labels
    return _convert_stub(obj, labels.label_schemes, "label scheme")


#: the positional arguments of the legacy ``build_model_torch`` partial
#: (reference ``medaka/models.py:380-436``)
LEGACY_ARGS = ("feature_len", "num_classes", "gru_size",
               "classify_activation", "time_steps")


def convert_model_function(obj) -> Dict:
    """Map a pickled model factory onto a {type, kwargs} model dict.

    Reads the modern ``partial(model_from_dict, {...})`` and the legacy
    ``partial(build_model_torch, feature_len, num_classes, gru_size,
    ...)``, which builds a ``GRUModel``; raises for anything else.
    """
    if isinstance(obj, functools.partial):
        func_name = _stub_name(obj.func) or getattr(
            obj.func, "__name__", "")
        args, kwargs = obj.args, obj.keywords or {}
        if func_name == "model_from_dict":
            return dict(args[0]) if args else dict(kwargs)
        if func_name in ("build_model_torch", "build_model"):
            merged = dict(zip(LEGACY_ARGS, args))
            merged.update(kwargs)
            out = {"num_features": merged.get("feature_len", 10),
                   "num_classes": merged.get("num_classes", 5)}
            if "gru_size" in merged:
                out["gru_size"] = merged["gru_size"]
            return {"type": "GRUModel", "kwargs": out}
        raise ValueError("Cannot convert the pickled model function "
                         "partial({}, ...)".format(func_name or obj.func))
    if isinstance(obj, MedakaStub):
        # a pickled model instance or factory call capture
        if obj._args and isinstance(obj._args[0], dict):
            return dict(obj._args[0])
        return {"type": _stub_name(obj), "kwargs": dict(obj._kwargs)}
    if isinstance(obj, dict) and "type" in obj:
        return obj
    raise ValueError("Cannot convert the pickled model function {!r}".format(
        obj))


def convert_meta(key: str, obj):
    """Convert one pickled HDF5 ``meta/`` item onto the port's objects
    (reference ``medaka/datastore.py:96-99`` stores feature_encoder,
    label_scheme and model_function); other keys pass as they are."""
    if key == "feature_encoder":
        return convert_feature_encoder(obj)
    if key == "label_scheme":
        return convert_label_scheme(obj)
    if key == "model_function":
        return convert_model_function(obj)
    return obj


def load_medaka_tgz(path: str):
    """Import a reference medaka model tarball into a ``ModelBundle``.

    The archive holds ``model/weights.pt`` (a torch state dict, read with
    ``torch.load(weights_only=True)``) and ``model/meta.pkl``
    ({model_function, label_scheme, feature_encoder}).
    """
    import torch

    from medaka_tpu_torch.models import ModelBundle, model_from_dict

    with tarfile.open(path, "r:*") as tar:
        names = tar.getnames()
        weights_name = next(
            (n for n in names if n.endswith("weights.pt")), None)
        meta_name = next((n for n in names if n.endswith(".pkl")), None)
        if weights_name is None or meta_name is None:
            raise ValueError(
                "{} is neither a native bundle nor a reference medaka model "
                "tarball (members: {})".format(path, names))
        meta = medaka_loads(tar.extractfile(meta_name).read())
        state = torch.load(io.BytesIO(tar.extractfile(weights_name).read()),
                           map_location="cpu", weights_only=True)
    if not isinstance(meta, dict) or "model_function" not in meta:
        raise ValueError("{}: meta.pkl holds no model_function".format(path))
    model = model_from_dict(convert_model_function(meta["model_function"]))
    model.load_torch_state(state)
    return ModelBundle(model, convert_feature_encoder(
        meta.get("feature_encoder")), convert_label_scheme(
        meta.get("label_scheme")))
