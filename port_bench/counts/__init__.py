"""Operations and bytes of each configuration, one module a configuration
(``counts/<config>.py``), counted from the algorithm's shapes: products at
2 operations a multiply-add, every input read once and every output
written once, whatever a kernel reads again."""
