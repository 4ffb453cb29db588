"""Model zoo (torch port of ``repro/models``): the recsys archs (GR
ranking, LSR, DLRM, two-tower, MIND, DIN/DIEN, BERT4Rec) with the MLP and
the DCNv2 and dot interactions, the LM family (``lm/``) and MACE
(``gnn/``)."""
