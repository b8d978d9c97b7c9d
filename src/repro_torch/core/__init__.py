"""Sketch math: hashing, HLL registers and estimators (with the JAX
package's functional API), intersection MLE, DegreeSketch's Algorithms
1, 2, 4 and 5, colored sketches and the ADS family."""
