"""Tools of the port, each runnable as ``python -m tpuspmm_torch.tools.<name>``.

Data tools (counterparts of ``tpuspmm/tools/``, the reference's
utils/python_utils/ scripts; their files are byte-identical to the JAX
tools' for the same inputs and seed):

- ``convert_mtx``       — .mtx → .csr / .coo / .bsr / both ELL pairs / dense.in
- ``gen_sparse``        — synthetic density-sweep directories
- ``gen_matrix``        — small random dense matrix files
- ``validate``          — the f64 oracle, ``result.expect``, ``*.out`` checks
- ``make_data``         — the medium_4096 stand-in, goldens, corpus check
- ``fetch_suitesparse`` — SuiteSparse downloader (needs a network)

Measurement tools: the panel-geometry ablation and the cost model's fit
(``ablate_panel``, ``fit_panel_model``; counterparts of
``bench/ablate_panel.py`` and ``bench/fit_panel_model.py``); per-strategy
device and host times (``profile_variants``), the card's measured memory
ceilings (``hbm_control``) and weak scaling over ranks
(``weak_scaling``), the counterparts of the ``bench/`` scripts of the
same names.
"""
