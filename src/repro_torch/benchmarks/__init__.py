"""The paper's tables on the port: Table I (`table1_matmul`) and Table II
(`table2_spmv`)."""
