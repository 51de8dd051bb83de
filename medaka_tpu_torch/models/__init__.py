"""Model registry, bundle loading and saving.

Counterpart of ``medaka_tpu/models/__init__.py`` (``load_model``,
``open_model``, ``save_model``, ``resolve_model`` with its download,
``download_model``, ``model_from_basecaller``, ``ModelBundle``, the
registry, ``DEFAULT_MODEL_DICT``). Bundles
are ``tar.gz`` archives of ``model/config.json`` (architecture, feature
encoder and label scheme configs) and ``model/weights.npz`` (the
parameter pytree flattened to ``a/0/b`` keys), so a bundle written by
either package loads in the other. A bundle whose model, feature encoder
or label scheme class is not ported yet is refused with an error naming
that class. Reference medaka ``.tar.gz`` checkpoints (``weights.pt`` and
a pickled ``meta.pkl``) load through :mod:`medaka_tpu_torch.compat`;
:func:`export_model` writes the other way, ``config.toml`` and a torch
``weights.pt`` (the dorado polish layout), whose ``config.toml`` ``train
--model`` reads as an architecture.
"""
from __future__ import annotations

import io
import json
import os
import tarfile
from typing import Dict, Optional

import numpy as np

from medaka_tpu_torch import common, options

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


def state_array(state: Dict, key: str) -> np.ndarray:
    """``state[key]`` (a tensor or array) as float32 numpy; a missing key
    raises naming it."""
    if key not in state:
        raise ValueError("The torch state dict lacks {} (keys: {})".format(
            key, ", ".join(sorted(state))))
    v = state[key]
    return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach")
                      else v, dtype=np.float32)


class TorchState:
    """A model's weights as the reference's torch state dict, through the
    JAX parameter pytree (the model's ``params_from_torch_state`` and
    ``torch_state_from_params``, counterparts of ``medaka_tpu``'s)."""

    def load_torch_state(self, state: Dict):
        """Load a reference checkpoint's state dict."""
        return self.load_jax_params(self.params_from_torch_state(state))

    def torch_state(self) -> Dict[str, np.ndarray]:
        """The weights as a reference state dict of numpy arrays."""
        return self.torch_state_from_params(self.jax_params())


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
    """Load a native bundle or a reference medaka checkpoint (see the
    module docstring)."""
    from medaka_tpu_torch import compat
    from medaka_tpu_torch import features as features_mod
    from medaka_tpu_torch import labels as labels_mod

    with open(path, "rb") as fh:
        if fh.read(40).startswith(b"version https://git-lfs"):
            raise ValueError("{} is a git-lfs pointer, not the model "
                             "itself.".format(path))
    with tarfile.open(path, "r:*") as tar:
        names = tar.getnames()
        for name in names:
            if name.startswith("/") or ".." in name:
                raise ValueError("Unsafe path in model archive: " + name)
        config_name = next(
            (n for n in names if n.endswith("config.json")), None)
        if config_name is None:
            return compat.load_medaka_tgz(path)
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


#: the bundles that ship with ``medaka_tpu`` (read by path), the first
#: of ``options.model_stores``
DATA_DIR = options.model_stores[0]


def _default_fetcher(url: str) -> bytes:
    """Fetch a URL's bytes (http(s):// and file://)."""
    import urllib.request

    with urllib.request.urlopen(url, timeout=120) as resp:
        return resp.read()


class DownloadError(RuntimeError):
    """Raised when a model cannot be fetched or validated."""


def download_model(name: str, fetcher=None, cache_dir: Optional[str] = None,
                   url_template: Optional[str] = None) -> str:
    """Download and cache a named model (``medaka_tpu.models.download_model``,
    reference ``models.py:39-139``).

    The file ``<name>_model_pt.tar.gz`` is fetched from ``url_template``
    (default :data:`options.model_url_template`; ``file://`` URLs work
    too), written to a ``.part`` file in ``cache_dir``, validated by
    :func:`load_model`, then moved into place; a blob that does not load
    is deleted and its error re-raised.

    :param name: model name, e.g. ``r1041_e82_400bps_sup_v5.0.0``.
    :param fetcher: callable url -> bytes (default urllib).
    :param cache_dir: target directory (default the user model store,
        ``options.model_stores[-1]``).
    :returns: path of the cached model file.
    """
    import tempfile

    logger = common.get_named_logger("ModelFetch")
    if fetcher is None:
        fetcher = _default_fetcher
    if cache_dir is None:
        cache_dir = options.model_stores[-1]
    template = url_template or options.model_url_template
    fname = name + "_model_pt.tar.gz"
    url = template.format(fname=fname)
    logger.info("Fetching %s", url)
    try:
        blob = fetcher(url)
    except Exception as e:
        raise DownloadError(
            "Could not fetch model {!r} from {} ({}). This environment "
            "may lack network egress; place the file under {} "
            "manually.".format(name, url, e, cache_dir)) from e
    os.makedirs(cache_dir, exist_ok=True)
    tmp = tempfile.NamedTemporaryFile(
        dir=cache_dir, suffix=".part", delete=False)
    try:
        tmp.write(blob)
        tmp.close()
        load_model(tmp.name)  # validation: must be a loadable bundle
        target = os.path.join(cache_dir, fname)
        os.replace(tmp.name, target)
    except Exception:
        os.unlink(tmp.name)
        raise
    logger.info("Cached %s", target)
    return target


def resolve_model(model: str, fetcher=None) -> str:
    """Resolve a model name or path to a loadable file path.

    The search order of ``medaka_tpu.models.resolve_model``: the path as
    given, then :data:`DATA_DIR` and the user's ``~/.medaka_tpu/data``,
    each with the suffixes ``_model_pt.tar.gz``, ``.tar.gz`` and none,
    then a download into the user store for a known model name
    (:func:`download_model` with ``fetcher``; a failed download raises
    ``FileNotFoundError``). A deprecated name raises
    ``options.DeprecationError``; any other name found nowhere raises
    ``FileNotFoundError``.
    """
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
        try:
            return download_model(model, fetcher=fetcher)
        except DownloadError as e:
            raise FileNotFoundError(str(e)) from e
    raise FileNotFoundError(
        "Could not resolve model {!r}; provide a model file path.".format(
            model))


def _models_from_bam(fname):
    """The ``basecall_model=`` values of the ``DS`` fields of a BAM's
    ``@RG`` header lines."""
    from medaka_tpu_torch.io.bam import BamReader
    found = set()
    with BamReader(fname) as reader:
        for line in reader.header_text.splitlines():
            if not line.startswith("@RG"):
                continue
            for field in line.split("\t"):
                if field.startswith("DS:"):
                    ds = field[3:]
                    if "basecall_model=" in ds:
                        found.add(ds.split("basecall_model=")[1].split()[0])
    return found


def _models_from_fastq(fname):
    """The basecaller models named in the comments of a FASTQ's first 100
    records: ``basecall_model_version_id=<model>``, or a catalogue name
    inside an ``RG:Z:<runid>_<model>_<barcode>`` tag."""
    import itertools

    from medaka_tpu_torch.io.fastx import read_fastx
    # longest names first: versioned entries must beat their
    # unversioned prefixes (e.g. ..._hac@v4.2.0 over ..._hac)
    known = sorted(options.basecaller_models, key=len, reverse=True)
    found = set()
    for rec in itertools.islice(read_fastx(fname), 100):
        comment = rec.comment or ""
        if "basecall_model_version_id=" in comment:
            found.add(
                comment.split("basecall_model_version_id=")[1].split()[0])
            continue
        for name in known:
            if name in comment:
                found.add(name)
                break
    return found


def model_from_basecaller(fname, variant=False, bacteria=False):
    """The model for a basecaller output file
    (``medaka_tpu.models.model_from_basecaller``, reference
    ``models.py:142-256``).

    A BAM's ``@RG`` ``DS`` fields are scanned for ``basecall_model=``,
    else a FASTQ's first 100 comments; the basecaller is looked up in
    ``options.basecaller_models``. Raises ``IOError`` when the file is
    neither, ``ValueError`` for zero or several basecallers or a missing
    variant model and ``KeyError`` for an unknown basecaller.
    ``bacteria`` picks the bacterial methylation model where the
    consensus model is compatible with it, else warns and keeps it.
    """
    logger = common.get_named_logger("MdlInspect")
    try:
        found = _models_from_bam(fname)
    except Exception:
        found = set()
    if not found:
        try:
            found = _models_from_fastq(fname)
        except Exception:
            raise IOError(
                "Failed to parse basecaller models from input file.")
    if len(found) != 1:
        raise ValueError(
            "Input file did not contain precisely 1 basecaller model "
            "reference.")
    basecaller = found.pop()
    if basecaller not in options.basecaller_models:
        raise KeyError(
            "Unknown basecaller model. Please provide a model "
            "explicitly using --model.")
    consensus, var = options.basecaller_models[basecaller]
    model = var if variant else consensus
    if model is None:
        raise ValueError(
            "No {} model available for basecaller {}.".format(
                "variant" if variant else "consensus", basecaller))
    if bacteria and not variant:
        if model in options.bact_methyl_compatible_models:
            model = options.bact_methyl_model
        else:
            logger.warning(
                "--bacteria specified but input data was not compatible; "
                "using default model %s.", model)
    return model


#: the ``config_version`` of :func:`export_model`'s ``config.toml``
#: (reference ``medaka/torch_ext.py:474-533``)
EXPORT_CONFIG_VERSION = 3


def _toml_value(v):
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return str(v)
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_toml_value(x) for x in v) + "]"
    return '"{}"'.format(str(v).replace('"', '\\"'))


def toml_dump(doc: Dict, fh, prefix=""):
    """Write ``doc`` as TOML (``medaka_tpu.models._toml_dump``): scalars
    and arrays as keys, nested dicts as tables, None values left out."""
    scalars = {k: v for k, v in doc.items()
               if not isinstance(v, dict) and v is not None}
    tables = {k: v for k, v in doc.items() if isinstance(v, dict)}
    for key, value in scalars.items():
        fh.write("{} = {}\n".format(key, _toml_value(value)))
    for key, value in tables.items():
        name = "{}.{}".format(prefix, key) if prefix else key
        fh.write("\n[{}]\n".format(name))
        toml_dump(value, fh, name)


def export_model(model_path: str, output: Optional[str] = None,
                 supported_basecallers: Optional[list] = None,
                 force: bool = False) -> str:
    """Export a model as ``output.tar.gz`` holding ``model/config.toml``
    and ``model/weights.pt`` (the reference's torch state dict, from
    ``torch_state``), as ``medaka_tpu.models.export_model`` does.

    :param output: archive path without ``.tar.gz`` (default: the model
        file's name with ``_export``).
    :returns: the archive's path.
    """
    import torch

    if output is None:
        output = os.path.basename(model_path).replace(".tar.gz", "_export")
    out_tar = output + ".tar.gz"
    if os.path.exists(out_tar) and not force:
        raise FileExistsError(
            "{} exists; pass force=True to overwrite.".format(out_tar))
    bundle = load_model(model_path)
    config = {
        "config_version": EXPORT_CONFIG_VERSION,
        "model": bundle.model.to_dict(),
        "feature_encoder": bundle.feature_encoder.to_dict()
        if bundle.feature_encoder else {},
        "supported_basecallers": supported_basecallers or [],
        "label_scheme": bundle.label_scheme.to_dict()
        if bundle.label_scheme else {},
    }
    text = io.StringIO()
    toml_dump(config, text)
    weights = io.BytesIO()
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in bundle.model.torch_state().items()}, weights)
    with tarfile.open(out_tar, "w:gz") as tar:
        for name, data in (("model/config.toml", text.getvalue().encode()),
                           ("model/weights.pt", weights.getvalue())):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    return out_tar


def read_toml_architecture(path: str) -> Dict:
    """The {type, kwargs} model dict of an architecture TOML: its
    ``[model]`` table, or the whole document when it has none (as
    ``medaka_tpu``'s ``train`` reads ``--model *.toml``)."""
    import tomllib

    with open(path, "rb") as fh:
        doc = tomllib.load(fh)
    model = doc.get("model", doc)
    if not isinstance(model, dict) or "type" not in model:
        raise ValueError("{} holds no model architecture (a [model] table "
                         "with a type)".format(path))
    return model


# register concrete models on import
from medaka_tpu_torch.models.gru import GRUModel  # noqa: E402,F401
from medaka_tpu_torch.models.latent_space_lstm import (  # noqa: E402,F401
    LatentSpaceLSTM)
from medaka_tpu_torch.models.majority import (  # noqa: E402,F401
    MajorityVoteModel)
