"""Property-based fuzzing of the port's NMS and connected components: on
``tests/test_property_fuzz.py``'s hypothesis volumes (its strategy,
imported) and windows, with its ``max_examples``, the port's ``nms`` and
``label_components`` equal the host references ``nms_host`` /
``components_host`` that define the semantics (ROADMAP queue 3's first
hazard).  The same comparison as the reference's fuzz tests: locations
exact for NMS and within 1e-3 for CC centroids, confidences to rtol 1e-6.
"""

import numpy as np
import torch
from hypothesis import given, settings, strategies as st

from flypylib_tpu.ops.host_reference import components_host, nms_host
from flypylib_tpu_torch.ops.components import label_components
from flypylib_tpu_torch.ops.nms import nms
from tests.test_detect_ops import assert_same_detections
from tests.test_property_fuzz import volumes

torch.set_num_threads(1)


@settings(max_examples=15, deadline=None)
@given(vol_s=volumes, window=st.sampled_from([2, 3, 5]))
def test_nms_fuzz(vol_s, window):
    vol, sparsity = vol_s
    thr = float(np.quantile(vol, sparsity))
    assert_same_detections(nms_host(vol, window=window, threshold=thr),
                           nms(vol, window=window, threshold=thr))
    # a tensor input runs on its device (here the CPU): the same list
    assert_same_detections(nms_host(vol, window=window, threshold=thr),
                           nms(torch.from_numpy(vol), window=window,
                               threshold=thr))


@settings(max_examples=10, deadline=None)
@given(vol_s=volumes)
def test_components_fuzz(vol_s):
    vol, sparsity = vol_s
    thr = float(np.quantile(vol, max(sparsity, 0.7)))
    assert_same_detections(components_host(vol, threshold=thr),
                           label_components(vol, threshold=thr), loc_tol=1e-3)
