"""mlstm kernel family: chunkwise-parallel mLSTM (prefill of xLSTM)."""
