"""The paper's own experiments (sec. 5) on the port: the convergence
harness and Figures 2-6, counterparts of the reference's
``benchmarks/{convergence,fig2_stagnation,fig3_quadratic,fig4_mlr,
fig5_mlr_lr,fig6_nn,table_formats,paper_models}.py`` with the same row
names (``name,us,derived``).  ``python -m repro_torch.paper.run`` runs them
on the card (``--device cpu``: the plain PyTorch path)."""
