"""The reference's benchmark harness on the card (counterparts of the JAX
package's ``bench/`` sweeps; the name ``bench`` is the headline bench's,
``tpuspmm_torch/bench.py``):

- ``sweep_formats``  ← ``bench/sweep_formats.py``: the CSR / COO / BSR /
  ELL engines over the corpus dirs (reference/test/{csr,coo,bsr}.sh);
- ``sweep_sparsity`` ← ``bench/sweep_sparsity.py``: the CSR and COO
  engines on 2048 × 2048 matrices at densities 0.1-0.9
  (reference/test/sparsity.sh);
- ``pruned_llm``     ← ``bench/pruned_llm.py``: the BSR engine's variants
  on 4096 × 4096 block-pruned weights (BASELINE config 4);
- ``summarize``      ← ``bench/summarize.py``: a table of the best kernel
  per (testcase, format);
- ``splice_sweep``   ← ``bench/splice_sweep.py``: re-run groups spliced
  into a sweep's records;
- ``common``: the device check and the record tally the sweeps share.

Each runs as ``python -m tpuspmm_torch.sweeps.<name>`` on the card unless
``--device cpu`` is given.  The records of the H100 runs are kept in
``h100/``.
"""
