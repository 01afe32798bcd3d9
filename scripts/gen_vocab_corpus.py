"""Generate one shard of the reference-scale vocabulary training corpus on
the host CPU (rendering is numpy; extraction runs on the CPU backend so the
accelerator stays free for the pipeline benches).

Usage: python scripts/gen_vocab_corpus.py SHARD N_SHARDS [IMAGES_PER_SHARD]
Writes /tmp/os1_vocab_shard_{SHARD}_{IMAGES}.npz (descs, docs).
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

import os1_tpu  # noqa: F401  (matmul precision config)
from os1_tpu.vocab.train import training_corpus


def main():
    shard = int(sys.argv[1])
    n_shards = int(sys.argv[2])
    images = int(sys.argv[3]) if len(sys.argv) > 3 else 1500
    out = f"/tmp/os1_vocab_shard_{shard}_{images}.npz"
    if os.path.exists(out):
        print(f"{out} exists")
        return
    t0 = time.time()
    descs, docs = training_corpus(
        n_images=images, n_features=1024, seed=1000 + 77 * shard
    )
    np.savez_compressed(out, descs=descs, docs=docs)
    print(f"shard {shard}/{n_shards}: {len(descs)} descs in "
          f"{time.time()-t0:.0f}s -> {out}")


if __name__ == "__main__":
    main()
