"""The plain reference that decides ``correct``: AnomalyCLIP's scoring and
training written out in plain PyTorch, fp32, with TF32 off.

A frozen copy of the mathematics of the CLIP ViT image tower and the causal
text tower (``clip.py``), the prompt learner, the ncentroid re-centring, the
selector's projections, the axial temporal transformer and the scoring head
(``anomaly.py``), the UCF-Crime losses and AdamW from ``torch.optim``
(``train.py``). It imports nothing of the program under test: no kernel, no
helper, no tokenizer (the prompts' token ids are data in each configuration's
file). ``precision.py`` holds the one switch the control needs: the same
products with their operands rounded to TF32.
"""
