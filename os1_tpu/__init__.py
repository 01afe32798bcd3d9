"""os1-tpu: a monocular visual SLAM engine written in JAX.

A from-scratch re-design of the capability set of the reference system
``AlejandroSilvestri/os1`` (an annotated ORB-SLAM2 fork in C++11) as jitted
XLA device programs over fixed-shape masked arrays, instead of a
mutex-guarded C++ object graph: batched ORB feature extraction, Hamming
matching, two-view initialization, tracking, local mapping with
Schur-complement bundle adjustment, BoW place recognition, Sim3 loop
closing, and map persistence. Its accelerator is an NVIDIA GPU (H100).

Layer map (mirrors reference layers, see SURVEY.md §1):
  pipeline/   System facade, Tracking FSM, LocalMapping, LoopClosing  (ref L3-L4)
  solvers/    two-view init, EPnP, Sim3 Horn RANSAC                    (ref L2)
  optim/      Levenberg-Marquardt, pose opt, Schur BA, pose graph      (ref g2o)
  features/   ORB pyramid extractor                                    (ref ORBextractor)
  matching/   Hamming matchers (projection / BoW / epipolar / fusion)  (ref ORBmatcher)
  vocab/      BoW vocabulary tree + inverted-file database             (ref DBoW2 + KeyFrameDatabase)
  map/        struct-of-arrays map store, covisibility                 (ref Map/KeyFrame/MapPoint)
  geometry/   SE3/Sim3, camera models, triangulation                   (ref Converter/g2o types)
  ops/        XLA building blocks (FAST, image ops, Hamming, top-k)
  parallel/   device meshes, sharded distributed BA
  io/         config, datasets, trajectory, Osmap-compatible persistence
  viz/        map/frame rendering, HUD
"""

__version__ = "0.1.0"

import jax as _jax

# Persistent XLA compilation cache: the pipeline's programs take far longer
# to compile than to run — cache them across processes (utils/cache.py).
from .utils.cache import enable_compilation_cache as _enable_cache

_enable_cache()

# Geometry accuracy is the product: a float32 matmul at the default
# precision may run through reduced-precision passes (bf16 on some
# accelerators, TF32 on NVIDIA tensor cores), which corrupts small-matrix
# geometry such as triangulation and the Sim3 exp/log round trip. Default
# the whole framework to true-f32 matmuls; throughput-critical kernels
# (Hamming dot, BRIEF sampling, pyramid resize) choose their own operand
# types explicitly where lower precision is safe.
_jax.config.update("jax_default_matmul_precision", "float32")
