"""vqa_attention_networks_tpu_torch — the PyTorch / CUDA port of the VQA
framework, for one NVIDIA Hopper card (sm_90a).

The JAX package ``vqa_attention_networks_tpu`` is the reference: every
module here names the JAX function it ports, and ``tests/test_torch_port_*``
hold each against it on the same weights and inputs. This package imports
``torch`` and nothing of JAX or of the JAX package: where it needs a module
that the JAX package has too (``config``, the ``data`` modules, the native
data plane, ``utils/torch_import``), it keeps its own copy.

Slices ported so far, on one device:

- bf16 ``mhb_coAtt`` serving, with the stage-1 fusion + co-attention kernel
  K1 (``csrc/stage1_coattention.cu``); under the ``VQA_PALLAS_GLIMPSE`` and
  ``VQA_FORCE_PALLAS`` switches also the glimpse block K7
  (``csrc/glimpse_attention.cu``) and the inference fusion K5
  (``csrc/train_fusion.cu``, ``train_fusion_inference_forward``);
- ``mhb_coAtt`` training through ``train/solver.py``, with the training
  fusion K2 (``csrc/train_fusion.cu``);
- bf16 ``hieCoAtten`` serving, with the co-attention core K4
  (``csrc/coattention.cu``);
- bf16 ``mfb`` and ``mfb-multilayer`` serving, with K5 under
  ``VQA_FORCE_PALLAS``;
- every family served (``serve.InferenceEngine``) and trained
  (``train.solver.Solver``), with checkpoints, resume, early stopping and
  the full evaluation's results files;
- the command line from corpus to results file: ``cli.prepare_data``,
  ``cli.build_glove``, ``cli.train`` and ``cli.evaluate``, over the data
  preparation of ``data/`` and the checkpoints, metric writer and ``.pth``
  importer of ``utils/``;
- serving as users reach it: ``cli.serve`` over HTTP, by image id from the
  device feature cache, and from image bytes through the backbones
  (``cli.predict``, ``cli.extract_features``);
- the Solver's switches: gradient accumulation, remat, the training
  feature bank (``train/feature_bank.py``), the int8 feed, the profiler
  and the NaN trap;
- the exported serving artifact (``aot.save_serving_artifact``,
  ``cli.export_serving``, ``cli.serve --aot_artifact``), whose graph calls
  K1, K4, K5 and K7 as ``torch.library`` custom ops (``torch.ops.vqa``).

- data parallelism over the ranks of a ``torch.distributed`` process
  group (``parallel/``, ``torchrun --nproc_per_node N``): the Solver's
  training, full evaluation and checkpoints with JAX's global-batch
  semantics, the replicated training bank, and
  ``InferenceEngine(data_parallel=N)``, one batch split over N replicas;
- tensor parallelism over the ``model`` mesh axis (``parallel/tensor.py``,
  ``parallel/sharding.py``: the fusion projections column-split as JAX's
  ``_leaf_spec`` places them, K2 and K3 on the shards), and the sharded
  feature banks: training's ring exchange over the data ranks
  (``train/feature_bank.py``) and the serving cache split over the
  engine's replicas (``serve.DeviceFeatureCache(devices=...)``).
"""

__version__ = "0.1.0"

from vqa_attention_networks_tpu_torch.config import Config  # noqa: F401
