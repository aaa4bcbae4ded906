"""Operations and bytes, from shapes: the model's per step (`model`), and
each port op call's (`port_ops`), against the peaks (`peaks`)."""
