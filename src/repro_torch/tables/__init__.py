"""The paper-table drivers on the port: Table III (small-model accuracy
under GRAU replacement), Tables IV/V (fit-quality sweep) and Table VI
(hardware cost). Run each as `python -m repro_torch.tables.<name>`."""
