"""Model registry, bundle loading and saving.

Counterpart of ``medaka_tpu/models/__init__.py`` (``load_model``,
``open_model``, ``save_model``, ``resolve_model``, ``ModelBundle``, the
registry, ``DEFAULT_MODEL_DICT``). Bundles
are ``tar.gz`` archives of ``model/config.json`` (architecture, feature
encoder and label scheme configs) and ``model/weights.npz`` (the
parameter pytree flattened to ``a/0/b`` keys), so a bundle written by
either package loads in the other. A bundle whose model, feature encoder
or label scheme class is not ported yet is refused with an error naming
that class. Reference medaka ``.tar.gz`` checkpoints (``weights.pt`` and
pickled metadata) are not ported yet.
"""
from __future__ import annotations

import io
import json
import os
import tarfile
from typing import Dict

import numpy as np

model_classes = {}

#: the architecture ``train`` builds when it is given none: the counts
#: GRUModel at full width
DEFAULT_MODEL_DICT = {
    "type": "GRUModel",
    "kwargs": {"num_features": 10, "num_classes": 5, "gru_size": 256},
}


def register_model(cls):
    """Class decorator adding a model to the registry."""
    model_classes[cls.__name__] = cls
    return cls


def model_from_dict(d: Dict):
    """Instantiate a model from a {type, kwargs} dict."""
    cls = model_classes.get(d["type"])
    if cls is None:
        raise NotImplementedError(
            "Model {} is not ported to medaka_tpu_torch yet (ported: "
            "{}).".format(d["type"], ", ".join(model_classes)))
    return cls(**d.get("kwargs", {}))


class ModelBundle:
    """A model (holding its weights) plus its data-processing configs."""

    def __init__(self, model, feature_encoder=None, label_scheme=None):
        """Bundle the components of a usable checkpoint."""
        self.model = model
        self.feature_encoder = feature_encoder
        self.label_scheme = label_scheme


def _flatten(tree, prefix="", sep="/") -> Dict[str, np.ndarray]:
    """'a/0/b' keys of a nested dict/list pytree (the JAX bundle keys)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    flat = {}
    for key, value in items:
        flat.update(_flatten(value, "{}{}{}".format(prefix, sep, key)
                             if prefix else str(key), sep))
    return flat


def _unflatten(flat: Dict[str, np.ndarray], sep="/"):
    """Rebuild the nested params pytree from 'a/b/0/c' style keys."""
    root: Dict = {}
    for key, value in flat.items():
        parts = key.split(sep)
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def save_model(path: str, model, feature_encoder=None,
               label_scheme=None) -> str:
    """Write a model bundle as tar.gz(config.json + weights.npz)."""
    config = {
        "format_version": 1,
        "model": model.to_dict(),
        "feature_encoder":
            feature_encoder.to_dict() if feature_encoder else None,
        "label_scheme": label_scheme.to_dict() if label_scheme else None,
    }
    buf_npz = io.BytesIO()
    np.savez(buf_npz, **_flatten(model.jax_params()))
    with tarfile.open(path, "w:gz") as tar:
        for name, data in (
                ("model/config.json", json.dumps(config, indent=2).encode()),
                ("model/weights.npz", buf_npz.getvalue())):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    return path


def load_model(path: str) -> ModelBundle:
    """Load a native model bundle (see the module docstring)."""
    from medaka_tpu_torch import features as features_mod
    from medaka_tpu_torch import labels as labels_mod

    with tarfile.open(path, "r:*") as tar:
        names = tar.getnames()
        for name in names:
            if name.startswith("/") or ".." in name:
                raise ValueError("Unsafe path in model archive: " + name)
        config_name = next(
            (n for n in names if n.endswith("config.json")), None)
        if config_name is None:
            raise NotImplementedError(
                "{} is not a native bundle (no config.json); reference "
                "medaka checkpoints are not ported to medaka_tpu_torch "
                "yet.".format(path))
        npz_name = next(n for n in names if n.endswith("weights.npz"))
        config = json.loads(tar.extractfile(config_name).read().decode())
        with np.load(io.BytesIO(tar.extractfile(npz_name).read())) as npz:
            flat = {k: npz[k] for k in npz.files}
    model = model_from_dict(config["model"])
    fenc = (features_mod.from_dict(config["feature_encoder"])
            if config.get("feature_encoder") else None)
    lsch = (labels_mod.from_dict(config["label_scheme"])
            if config.get("label_scheme") else None)
    model.load_jax_params(_unflatten(flat))
    return ModelBundle(model, fenc, lsch)


def open_model(path: str) -> ModelBundle:
    """Alias of :func:`load_model` (reference API name)."""
    return load_model(path)


#: the bundles that ship with ``medaka_tpu`` (read by path)
DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "..", "medaka_tpu", "data")


def resolve_model(model: str) -> str:
    """Resolve a model name or path to a loadable file path.

    The search order of ``medaka_tpu.models.resolve_model``: the path as
    given, then :data:`DATA_DIR` and the user's ``~/.medaka_tpu/data``,
    each with the suffixes ``_model_pt.tar.gz``, ``.tar.gz`` and none. A
    deprecated name raises ``options.DeprecationError``; a name found
    nowhere raises ``FileNotFoundError``, known model or not: the port
    downloads nothing.
    """
    from medaka_tpu_torch import options

    if os.path.exists(model):
        return model
    if model in options.deprecated_models:
        raise options.DeprecationError(model)
    home = os.path.join(os.path.expanduser("~"), ".medaka_tpu", "data")
    for base in (DATA_DIR, home):
        for suffix in ("_model_pt.tar.gz", ".tar.gz", ""):
            candidate = os.path.join(base, model + suffix)
            if os.path.exists(candidate):
                return candidate
    if model in options.known_models:
        raise FileNotFoundError(
            "Model {!r} is not on disk; place its file under {} (the port "
            "downloads nothing).".format(model, home))
    raise FileNotFoundError(
        "Could not resolve model {!r}; provide a model file path.".format(
            model))


# register concrete models on import
from medaka_tpu_torch.models.gru import GRUModel  # noqa: E402,F401
from medaka_tpu_torch.models.latent_space_lstm import (  # noqa: E402,F401
    LatentSpaceLSTM)
from medaka_tpu_torch.models.majority import (  # noqa: E402,F401
    MajorityVoteModel)
