"""Model registry: arch name -> port ``nn.Module``.

Counterpart of ``bodyct_dram_emph_subtype_tpu/models/registry.py`` with the
same six reference arch names (``conf/*.yaml`` + ``utils.py:83-85``):

  med3d      -> resnet34segcls   med3ddram    -> resnet34segreg
  med3d18    -> resnet18segcls   med3ddram18  -> resnet18segreg
  med3d50    -> resnet50segcls   med3ddram50  -> resnet50segreg

plus the tiny 1-block-per-layer archs (``med3dtiny``, ``med3ddramtiny``)
and the plain baselines ``resnet34`` / ``resnet50``.  Repo-local
``conf/<name>.yaml`` files are read first, as in the JAX package; their
``n_classes`` reaches the classification factories and is dropped for
the dRAM ones, which have no class heads.
"""
from __future__ import annotations

import logging
import re
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

from .blocks import BasicBlock, Bottleneck
from .resnet3d import ResNet, ResNetSegCls, ResNetSegReg

logger = logging.getLogger(__name__)


def resnet18segcls(**kw):
    return ResNetSegCls(BasicBlock, (2, 2, 2, 2), **kw)


def resnet34segcls(**kw):
    return ResNetSegCls(BasicBlock, (3, 4, 6, 3), **kw)


def resnet50segcls(**kw):
    return ResNetSegCls(Bottleneck, (3, 4, 6, 3), **kw)


def resnet18segreg(**kw):
    return ResNetSegReg(BasicBlock, (2, 2, 2, 2), **kw)


def resnet34segreg(**kw):
    return ResNetSegReg(BasicBlock, (3, 4, 6, 3), **kw)


def resnet50segreg(**kw):
    return ResNetSegReg(Bottleneck, (3, 4, 6, 3), **kw)


def resnet34(**kw):
    return ResNet(BasicBlock, (3, 4, 6, 3), **kw)


def resnet50(**kw):
    return ResNet(Bottleneck, (3, 4, 6, 3), **kw)


def resnettinysegcls(**kw):
    return ResNetSegCls(BasicBlock, (1, 1, 1, 1), **kw)


def resnettinysegreg(**kw):
    return ResNetSegReg(BasicBlock, (1, 1, 1, 1), **kw)


_FACTORIES = {
    "resnet18segcls": resnet18segcls,
    "resnet34segcls": resnet34segcls,
    "resnet50segcls": resnet50segcls,
    "resnet18segreg": resnet18segreg,
    "resnet34segreg": resnet34segreg,
    "resnet50segreg": resnet50segreg,
    "resnet34": resnet34,
    "resnet50": resnet50,
    "resnettinysegcls": resnettinysegcls,
    "resnettinysegreg": resnettinysegreg,
}
# the plain classifiers (ResNet): no decoder and no lung-mask argument
PLAIN_FACTORIES = ("resnet34", "resnet50")

_ARCH_TO_TARGET = {
    "med3d": ("resnet34segcls", {"n_classes": (6, 3)}),
    "med3d18": ("resnet18segcls", {"n_classes": (6, 3)}),
    "med3d50": ("resnet50segcls", {"n_classes": (6, 3)}),
    "med3ddram": ("resnet34segreg", {}),
    "med3ddram18": ("resnet18segreg", {}),
    "med3ddram50": ("resnet50segreg", {}),
    "med3dtiny": ("resnettinysegcls", {"n_classes": (6, 3)}),
    "med3ddramtiny": ("resnettinysegreg", {}),
}


def _parse_conf_yaml(path: Path) -> Dict[str, Any]:
    """Minimal parser for the reference's one-liner configs: ``_target_:
    med3d.<factory>`` plus optional ``n_classes: [a, b]``."""
    cfg: Dict[str, Any] = {}
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#") or ":" not in line:
            continue
        key, value = (s.strip() for s in line.split(":", 1))
        if key == "_target_":
            cfg["_target_"] = value.split(".")[-1]
        elif key == "n_classes":
            cfg["n_classes"] = tuple(
                int(v) for v in re.findall(r"-?\d+", value))
        else:
            cfg[key] = value
    return cfg


def resolve_arch(name: str, conf_dir: Optional[str] = None
                 ) -> Tuple[str, Dict[str, Any]]:
    """(factory name, constructor kwargs) of arch ``name``: repo-local
    ``conf/<name>.yaml`` (from ``conf_dir``, ``./conf`` or the repo's
    ``conf/``), then the built-in arch table, then direct factory names."""
    search = [Path(conf_dir)] if conf_dir else [
        Path("conf"), Path(__file__).resolve().parents[2] / "conf"]
    for base in search:
        path = base / f"{name}.yaml"
        if path.exists():
            cfg = _parse_conf_yaml(path)
            target = cfg.pop("_target_", None)
            if target in _FACTORIES:
                if target.endswith("segreg"):
                    # n_classes configures the classification heads only
                    cfg.pop("n_classes", None)
                return target, cfg
            logger.warning(
                "config %s has unknown _target_ %r (known factories: %s); "
                "falling back to the builtin arch table for %r",
                path, target, sorted(_FACTORIES), name)
    if name in _ARCH_TO_TARGET:
        target, kwargs = _ARCH_TO_TARGET[name]
        return target, dict(kwargs)
    if name in _FACTORIES:
        return name, {}
    raise KeyError(f"unknown model arch: {name!r}; "
                   f"known: {sorted(_ARCH_TO_TARGET) + sorted(_FACTORIES)}")


def get_model_by_name(name: str, conf_dir: Optional[str] = None,
                      **overrides):
    """Build a model by arch name (:func:`resolve_arch`); ``overrides``
    go to the model's constructor (e.g. ``generator=``,
    ``packed_decoder=``, ``remat=``, as the JAX registry passes them)."""
    target, kwargs = resolve_arch(name, conf_dir)
    return _FACTORIES[target](**{**kwargs, **overrides})
