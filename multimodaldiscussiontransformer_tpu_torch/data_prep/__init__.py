"""Offline dataset construction: the PyTorch port's copy of the JAX
package's ``data_prep/``, itself a port of the reference's
``Pre-Processing/`` stage scripts (SURVEY.md §2.1 L0):

stage 0  labels.py       normalize CAD / Slurs / LTI corpora to (id, link_id, label)
stage 1  gather.py       locate + filter Pushshift monthly dumps (network)
stage 2  trees.py        join labels, build nested discussion trees
stage 3  trees.py        prune unlabelled branches (depth < 7, top-k subtrees)
stage 4  images.py       fetch + resize imgur images (network)
stage 5  splits.py       dedupe + train/test split generation (the script the
                         reference pipeline references but never ships —
                         SURVEY.md §2.1 "Gap")
stage 6  text_export.py  flatten trees to per-comment parquet splits
"""
