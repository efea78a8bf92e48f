"""Dict-in/dict-out per-sample transform framework.

Counterpart of ``bodyct_dram_emph_subtype_tpu/transforms/base.py``
(reference ``base.py:17-231``), with its protocol:

- dict in, dict out; the key decides which apply method runs: a key that
  holds "image", "mask", "box" or "points" (reference ``base.py:119-133``);
  values that are not arrays pass through;
- the probability gate ``p``, ``always_apply`` and ``freeze_param`` (apply
  the cached ``params`` again, drawing nothing; reference ``base.py:81-89``);
- ``to_dict``/``__repr__`` and the range validators.

Randomness.  The JAX package turns a ``jax.random`` key into a
``np.random.RandomState`` (``key_to_rng``) and draws every parameter with
numpy on the host.  The port takes the RandomState itself, or an ``int``
seed of one: ``transform(data, rng)``; without ``rng`` the global
``np.random`` draws, as in the JAX package.  :class:`Compose` deals each
member an ``int`` seed drawn from its own RandomState; it does not copy
``jax.random.split``, whose stream torch cannot reproduce.  So one
RandomState gives the same parameters here as in the JAX package
(``get_params``), and each apply step can be held against JAX exactly.
The apply steps are torch ops and run where the tensors lie.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..utils.device import entry_device

Rng = Union[None, int, np.random.RandomState]


def as_rng(rng: Rng):
    """``rng`` as a numpy random source: a RandomState as it is, an int as
    the seed of a new one, None as the global ``np.random``."""
    if rng is None:
        return np.random
    if isinstance(rng, np.random.RandomState):
        return rng
    return np.random.RandomState(int(rng))


def as_tensor(data) -> torch.Tensor:
    """A tensor as it is; an array as a CPU tensor of its dtype (sharing
    its memory where the array is contiguous and writable)."""
    if isinstance(data, torch.Tensor):
        return data
    data = np.asarray(data)
    if not data.flags.writeable:
        data = data.copy()
    return torch.as_tensor(np.ascontiguousarray(data))


class BaseTransform:
    """Base of every transform; see the module docstring for the
    protocol."""

    def __init__(self, p: float = 0.5, always_apply: bool = False,
                 freeze_param: bool = False):
        self.p = p
        self.always_apply = always_apply
        self.freeze_param = freeze_param
        self.params: Dict[str, Any] = {}

    # ------------------------------------------------------------ protocol
    def __call__(self, data_dict: Dict[str, Any],
                 rng: Rng = None) -> Dict[str, Any]:
        if self.freeze_param:
            return self.apply_with_params(self.params, data_dict)
        rng = as_rng(rng)
        if self.always_apply or rng.random_sample() < self.p:
            params = self.get_params(data_dict, rng)
            return self.apply_with_params(params, data_dict)
        return data_dict

    def get_params(self, data_dict: Dict[str, Any], rng) -> Dict[str, Any]:
        return {}

    def apply_with_params(self, params: Dict[str, Any],
                          data_dict: Dict[str, Any]) -> Dict[str, Any]:
        self.params.update(params)
        return {key: (self.apply_function_on_key(key, data)
                      if self._is_array_like(data) else data)
                for key, data in data_dict.items()}

    @staticmethod
    def _is_array_like(data: Any) -> bool:
        return isinstance(data, (np.ndarray, torch.Tensor))

    def apply_function_on_key(self, key: str, data: Any):
        if "image" in key:
            return self.apply_to_image(data)
        if "mask" in key:
            return self.apply_to_mask(data)
        if "box" in key:
            return self.apply_to_box(data)
        if "points" in key:
            return self.apply_to_point_cloud(data)
        return data

    # ------------------------------------------------------- apply methods
    def apply_to_image(self, data: Any):
        raise NotImplementedError(
            f"apply_to_image not implemented in {type(self).__name__}")

    def apply_to_mask(self, data: Any):
        raise NotImplementedError(
            f"apply_to_mask not implemented in {type(self).__name__}")

    def apply_to_box(self, data: Any):
        raise NotImplementedError(
            f"apply_to_box not implemented in {type(self).__name__}")

    def apply_to_point_cloud(self, data: Any):
        raise NotImplementedError(
            f"apply_to_point_cloud not implemented in {type(self).__name__}")

    # -------------------------------------------------------- serialization
    def __repr__(self):
        return json.dumps(self.to_dict(), indent=4, default=str)

    def to_dict(self) -> Dict[str, Any]:
        state = {"__class_fullname__":
                 f"{type(self).__module__}.{type(self).__name__}",
                 "always_apply": self.always_apply, "p": self.p}
        state.update({k: getattr(self, k)
                      for k in self.get_transform_init_args_names()})
        state.update({"randomized_params": self.params})
        return state

    def get_transform_init_args_names(self) -> Tuple[str, ...]:
        return tuple()

    # --------------------------------------------------------- validators
    @staticmethod
    def check_range(value, name):
        if not (isinstance(value, (tuple, list)) and len(value) == 2
                and value[0] <= value[1]):
            raise ValueError(f"{name} must be an ordered (lo, hi) pair")
        return tuple(value)

    @staticmethod
    def check_positive_range(value, name):
        if not (isinstance(value, (tuple, list)) and len(value) == 2
                and 0 <= value[0] <= value[1]):
            raise ValueError(f"{name} must be an ordered non-negative pair")
        return tuple(value)


class ImageOnlyTransform(BaseTransform):
    """Applies only to keys that hold 'image' (reference
    ``intensity_transforms.py:15-24``)."""

    def apply_function_on_key(self, key: str, data: Any):
        if "image" in key:
            return self.apply_to_image(data)
        return data


class DualTransform(BaseTransform):
    """Applies to 'image' and 'mask' keys (reference
    ``spatial_transforms.py:17-30``)."""

    def apply_function_on_key(self, key: str, data: Any):
        if "image" in key:
            return self.apply_to_image(data)
        if "mask" in key:
            return self.apply_to_mask(data)
        return data


class Compose:
    """The transforms in order; with ``rng``, each member gets an ``int``
    seed drawn from ``rng``'s RandomState, one per member."""

    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, data_dict: Dict[str, Any],
                 rng: Rng = None) -> Dict[str, Any]:
        if rng is None:
            seeds = [None] * len(self.transforms)
        else:
            seeds = [int(s) for s in as_rng(rng).randint(
                0, 2 ** 31 - 1, size=len(self.transforms))]
        for transform, seed in zip(self.transforms, seeds):
            data_dict = transform(data_dict, seed)
        return data_dict

    def __repr__(self):
        inner = ",\n".join(repr(t) for t in self.transforms)
        return f"Compose([\n{inner}\n])"


class ToDevice(BaseTransform):
    """numpy arrays -> tensors on ``device`` (the reference's
    ``NumpyToTensor``, ``base.py:208-218``).  ``device``: as
    ``utils/device.py::entry_device`` takes it, so the default is the CUDA
    card, and without one this raises unless ``device="cpu"`` is given."""

    def __init__(self, device: Optional[Union[str, torch.device]] = None):
        super().__init__(1.0, True)
        self.device = entry_device(device)

    def apply_with_params(self, params, data_dict):
        return {k: (as_tensor(v).to(self.device)
                    if isinstance(v, np.ndarray) else v)
                for k, v in data_dict.items()}

    def __call__(self, data_dict, rng=None):
        return self.apply_with_params({}, data_dict)


class ToHost(BaseTransform):
    """Tensors -> numpy arrays (the reference's ``TensorToNumpy``,
    ``base.py:221-231``)."""

    def __init__(self):
        super().__init__(1.0, True)

    def __call__(self, data_dict, rng=None):
        return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                    else v)
                for k, v in data_dict.items()}
