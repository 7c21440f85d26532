"""BSPOA: banded striped partial-order alignment, consensus and SNV calling
(port of bsalign_tpu.poa)."""
