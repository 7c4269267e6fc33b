"""Single-cell analysis (the port's copy of
``preprocessings/single_cell_analysis/extract_expression_matrix.py``): the
per-nucleus expression matrix of a slide, pooled on the card. The JAX
package's ``gmm_gating.py`` imports nothing of it and runs as it is."""
