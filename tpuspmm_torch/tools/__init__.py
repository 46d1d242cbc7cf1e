"""Measurement tools of the port: the panel-geometry ablation and the cost
model's fit (counterparts of ``bench/ablate_panel.py`` and
``bench/fit_panel_model.py``)."""
