"""Carry state from the reference into the port.

The reference hands its state around as arrays (numpy on the host); these
functions take such arrays and return the port's objects on a device:

* :func:`serving_model` — trained factors ``X``, ``Y`` with their id lists
  (and optionally each user's known items) → a loaded
  :class:`~oryx_tpu_torch.models.als.serving.ALSServingModel`;
* :func:`init_y` — an initial item-factor matrix, such as the reference's
  ``train._init_factors(padded_rows, n_items, k, key)`` → the ``init_y``
  argument of the port's ``als_train``. ``jax.random`` streams cannot be
  reproduced in torch, so a test that compares trained values starts both
  trainers from the same Y₀ this way;
* :func:`kmeans_centers` — starting centres, such as the reference's
  ``train._init_centers(key, points, k, init)`` → the ``init_centers``
  argument of the port's ``kmeans_train``, for the same reason;
* :func:`kmeans_serving_model` — clusters (the reference's ``ClusterInfo``
  list or a PMML ClusteringModel written by either package) → a loaded
  :class:`~oryx_tpu_torch.models.kmeans.serving.KMeansServingModel`.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Mapping, Sequence

import numpy as np
import torch

from oryx_tpu_torch.common.device import resolve
from oryx_tpu_torch.models.als.serving import ALSServingModel
from oryx_tpu_torch.models.kmeans import pmml_codec
from oryx_tpu_torch.models.kmeans.model import ClusterInfo
from oryx_tpu_torch.models.kmeans.serving import KMeansServingModel
from oryx_tpu_torch.models.schema import InputSchema


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float32)


def serving_model(x, y, user_ids: Sequence[str], item_ids: Sequence[str], *,
                  implicit: bool = True,
                  known_items: "Mapping[str, Sequence[str]] | None" = None,
                  device=None) -> ALSServingModel:
    """A serving model loaded with ``x`` (users × k) and ``y`` (items × k),
    whose rows follow ``user_ids`` and ``item_ids``."""
    y_host = _host(y)
    model = ALSServingModel(y_host.shape[1], implicit, device=device)
    model.bulk_load_users(list(user_ids), _host(x))
    model.bulk_load_items(list(item_ids), y_host)
    for user, items in (known_items or {}).items():
        model.add_known_items(user, items)
    return model


def init_y(y0, device=None) -> torch.Tensor:
    """Initial item factors as a float32 tensor on ``device`` (a copy: the
    reference's arrays may be read-only views)."""
    return torch.tensor(_host(y0), device=resolve(device))


def kmeans_centers(centers, device=None) -> torch.Tensor:
    """Starting centres (k, d), or one set per run (runs, k, d), as a
    float32 tensor on ``device`` (a copy)."""
    return torch.tensor(_host(centers), device=resolve(device))


def kmeans_serving_model(clusters_or_pmml,
                         schema: InputSchema) -> KMeansServingModel:
    """A serving model holding ``clusters_or_pmml``: a PMML document (an
    ``xml.etree`` element, as both packages' codecs produce) or a sequence
    of clusters with ``id``, ``center`` and ``count``."""
    if isinstance(clusters_or_pmml, ET.Element):
        pmml_codec.validate_pmml_vs_schema(clusters_or_pmml, schema)
        clusters = pmml_codec.read(clusters_or_pmml)
    else:
        clusters = [ClusterInfo(c.id, np.asarray(c.center, dtype=np.float64),
                                c.count) for c in clusters_or_pmml]
    return KMeansServingModel(clusters, schema)
