"""Static helpers of the port.  ``workspace`` holds the shared per-launch
working-set byte estimators (the autotuner delegates here); the JAX
package's launch verifier, lint rules and fingerprint audit are not ported
yet."""
