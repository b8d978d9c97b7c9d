"""Sketch math: hashing, HLL registers and estimators, intersection MLE."""
