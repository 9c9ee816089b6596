"""KNOWN-BAD: a host sync inside the train step.

``float(loss)`` waits for the card to finish the step before the host can
enqueue the next one.
"""


def train_step(state, cfg, images, labels):
    loss = state.model(images).sum()
    loss.backward()
    state.optimizer.step()
    return {"loss": float(loss)}
